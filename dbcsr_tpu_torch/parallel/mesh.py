"""The 2.5D process grid: a ('kl', 'pr', 'pc') grid of image slots.

Counterpart of `dbcsr_tpu/parallel/mesh.py`, which builds a
`jax.sharding.Mesh` over devices.  Here a `Grid` is a list of image
slots, each a (rank, torch.device) pair; devices may repeat, so one
process can put every image of a grid on one card (or on the CPU, as
the tests do with ``devices=[cpu] * 8``), and a multi-process world
(`parallel/multihost.py`) deals the images over its ranks.

Axes: kl = 3D k-layers (ref NUM_LAYERS_3D, `dbcsr_mm_3d.F:983-1134`),
pr x pc = the Cannon grid (ref `dbcsr_mp_type`, `dbcsr_types.F:110-134`).
Image (l, i, j) has the flat index (l * pr + i) * pc + j.

Moving a panel between images (`Grid.shift`): between images of one
process on one device the tensor is handed over, across devices it is
copied with ``.to()`` (on a side CUDA stream between two cards), and
across ranks it travels host-staged as a CPU tensor through
`torch.distributed`'s point-to-point calls (the gloo backend; DBCSR's
path without GPU-aware MPI).

Shape policy (`grid_shape`, the JAX package's rules): square pr == pc
grids run the skewed sparse Cannon; when the image count has no usable
square factor (6, 10, 14, ...) or an explicit layer count forces it (8
images, layers=1), the grid goes rectangular and the sparse engine
takes the all-gather algorithm.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dbcsr_tpu_torch.device import DeviceLike, resolve_device

AXES = ("kl", "pr", "pc")


def _balanced_factor(q: int) -> Tuple[int, int]:
    """(pr, pc) with pr * pc == q, pr <= pc, as close to square as
    possible (pr = largest divisor <= sqrt(q))."""
    pr = 1
    for d in range(int(np.sqrt(q)), 0, -1):
        if q % d == 0:
            pr = d
            break
    return pr, q // pr


def grid_shape(n_devices: int, layers: Optional[int] = None) -> Tuple[int, int, int]:
    """Pick (kl, pr, pc) with kl * pr * pc == n_devices.

    Preference order: the largest SQUARE pr == pc grid (fewest layers;
    runs the skewed Cannon), else a rectangular balanced pr x pc (runs
    the all-gather engine).  ``layers=None`` consults the NUM_LAYERS_3D
    analog (`config.num_layers_3d`, ref `dbcsr_config.F:152`) before
    auto-choosing; an explicit layer count is honored exactly, going
    rectangular when n/layers is not a perfect square."""
    if layers is None:
        from dbcsr_tpu_torch.core.config import get_config

        cfg_layers = get_config().num_layers_3d
        if cfg_layers >= 1:
            layers = cfg_layers
    if layers is not None:
        q, rem = divmod(n_devices, layers)
        if rem:
            raise ValueError(f"{n_devices} devices not divisible by {layers} layers")
        s = int(round(np.sqrt(q)))
        if s * s == q:
            return layers, s, s
        pr, pc = _balanced_factor(q)
        return layers, pr, pc
    for s in range(int(np.sqrt(n_devices)), 1, -1):
        if n_devices % (s * s) == 0:
            return n_devices // (s * s), s, s
    pr, pc = _balanced_factor(n_devices)
    return 1, pr, pc


class Grid:
    """A (kl, pr, pc) grid of image slots, each a (rank, device).

    ``shape`` maps the axis names to their sizes, as a JAX mesh's does;
    ``devices`` is the (kl, pr, pc) array of the slots' devices.  A slot
    whose rank is not this process's (`multihost.process_id`) is
    remote: this process neither holds nor computes that image."""

    def __init__(self, shape: Sequence[int], slots: Sequence[Tuple[int, torch.device]]):
        kl, pr, pc = (int(x) for x in shape)
        if kl * pr * pc != len(slots) or min(kl, pr, pc) < 1:
            raise ValueError(f"grid {kl}x{pr}x{pc} needs {kl * pr * pc} slots, "
                             f"got {len(slots)}")
        self.kl, self.pr, self.pc = kl, pr, pc
        self.shape = {"kl": kl, "pr": pr, "pc": pc}
        self.slots = tuple((int(r), torch.device(d)) for r, d in slots)
        self.devices = np.empty(len(self.slots), object)
        self.devices[:] = [d for _, d in self.slots]
        self.devices = self.devices.reshape(kl, pr, pc)
        from dbcsr_tpu_torch.parallel import multihost

        self._rank = multihost.process_id()
        self._nranks = len({r for r, _ in self.slots})
        if self._nranks > 1 and multihost.process_count() < self._nranks:
            raise RuntimeError(f"the grid spans {self._nranks} ranks but this process "
                               f"is in a world of {multihost.process_count()}")

    axis_names = AXES

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def multiprocess(self) -> bool:
        return self._nranks > 1

    def key(self) -> tuple:
        """Hashable structure of the grid (plan-cache keys): the shape
        and every slot."""
        return ((self.kl, self.pr, self.pc),
                tuple((r, str(d)) for r, d in self.slots))

    def label(self) -> str:
        return f"{self.kl}x{self.pr}x{self.pc}"

    def image(self, l: int, i: int, j: int) -> int:
        return (l * self.pr + i) * self.pc + j

    def coords(self, img: int) -> Tuple[int, int, int]:
        return img // (self.pr * self.pc), (img // self.pc) % self.pr, img % self.pc

    def local(self, img: int) -> bool:
        return self.slots[img][0] == self._rank

    def local_images(self) -> List[int]:
        return [g for g in range(self.size) if self.local(g)]

    def device_of(self, img: int) -> torch.device:
        return self.slots[img][1]

    def home(self) -> torch.device:
        """The device results are assembled on: this process's first
        image's."""
        return self.device_of(self.local_images()[0])

    def __repr__(self) -> str:
        return f"Grid({self.label()}, slots={list(self.slots)})"

    # ---------------------------------------------------------------- moves
    def shift(self, panels: list, src_of: Sequence[int], tag: int = 0) -> "PendingShift":
        """Start moving ``panels[src_of[d]]`` to every image d (the
        reference's isend/irecv panel exchange, `dbcsr_mm_cannon.F:1420-1590`).
        ``panels`` holds a tensor for every local image (None elsewhere),
        all of one shape and dtype.  Returns a handle whose `wait` gives
        the new list."""
        out: list = [None] * self.size
        sends, recvs = [], []
        like = next(p for p in panels if p is not None)
        for d in range(self.size):
            s = src_of[d]
            if self.local(d) and self.local(s):
                out[d] = _to_device(panels[s], self.device_of(d))
            elif self.local(s):
                sends.append((panels[s], self.slots[d][0], tag + d))
            elif self.local(d):
                recvs.append((d, self.slots[s][0], tag + d))
        if not sends and not recvs:
            return PendingShift(out)
        from dbcsr_tpu_torch.parallel import multihost

        return multihost.post_exchange(self, out, sends, recvs, like)

    def gather_all(self, tensors: list) -> list:
        """Every image's tensor on this process (the panels of remote
        images arrive host-staged from their owners, in image order).
        In one process this is the list itself."""
        if not self.multiprocess:
            return list(tensors)
        from dbcsr_tpu_torch.parallel import multihost

        return multihost.gather_images(self, tensors)


class PendingShift:
    """The result of a `Grid.shift` in flight: `wait` returns the list of
    the images' new tensors."""

    def __init__(self, out: list, handles=(), recvs=(), staged=None, sent=()):
        self._out = out
        self._handles = list(handles)
        self._recvs = list(recvs)  # (image, host buffer, device)
        self._staged = staged       # (bytes, t0): host-staged traffic
        self._sent = list(sent)     # host copies alive until their sends complete
        self._done = False

    def wait(self) -> list:
        if not self._done:
            for h in self._handles:
                h.wait()
            for d, buf, dev in self._recvs:
                self._out[d] = buf.to(dev)
            if self._staged is not None:
                from dbcsr_tpu_torch.parallel import multihost

                multihost.note_staged("shift", self._staged[0],
                                      time.perf_counter() - self._staged[1], len(self._handles))
            self._done = True
        return self._out


_side_streams: dict = {}


def _to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """Hand ``t`` over when it already lies on ``dev``; between two cards
    copy it on a side stream that the consumer's stream then waits for."""
    if t.device == dev:
        return t
    if t.device.type == "cuda" and dev.type == "cuda":
        stream = _side_streams.get(dev)
        if stream is None:
            stream = _side_streams[dev] = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(stream):
            out = t.to(dev, non_blocking=True)
        torch.cuda.current_stream(dev).wait_stream(stream)
        out.record_stream(torch.cuda.current_stream(dev))
        return out
    return t.to(dev)


def make_grid(n_devices: Optional[int] = None, devices=None,
              layers: Optional[int] = None, device: Optional[DeviceLike] = None) -> Grid:
    """Build the ('kl','pr','pc') grid of one process (ref `mp_cart_create`).

    ``devices`` lists one device per image (they may repeat); without
    it the grid has ``n_devices`` images on ``device`` (default: the
    default device), or one image per CUDA card when ``n_devices`` is
    None and the device is a card."""
    if devices is None:
        dev = resolve_device(device)
        if n_devices is None:
            n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
            devices = ([torch.device("cuda", i) for i in range(n_devices)]
                       if dev.type == "cuda" else [dev])
        else:
            devices = [dev] * n_devices
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    from dbcsr_tpu_torch.parallel import multihost

    rank = multihost.process_id()
    kl, pr, pc = grid_shape(len(devices), layers)
    return Grid((kl, pr, pc), [(rank, d) for d in devices])


def optimize_grid(grid: Grid, nsplit: int, long_dim: str) -> Grid:
    """Re-factor the SAME slots into the ('kl','pr','pc') shape that best
    fits a batch of contractions — the analog of the reference's batched
    pgrid re-optimization (`dbcsr_tensor.F:1964-2186` re-chooses
    process-grid dims between tensor batches).

    m/n-long (grouped TAS) batches want the group axis as large as the
    computed nsplit can fill: kl positions beyond nsplit would idle, so
    pick the largest kl <= nsplit (the always-offered kl=1 rectangular
    candidate guarantees a match).  k-long batches run 2.5D k-layers,
    whose replication optimum scales like n^(1/3)
    (communication-avoiding Cannon): pick kl nearest that.  Returns the
    input grid unchanged when it already matches."""
    n = grid.size
    cands = [(n // (s * s), s, s) for s in range(1, int(round(n ** 0.5)) + 1)
             if n % (s * s) == 0]
    # always offer the balanced rectangular single-layer grid (all-gather
    # engine): it keeps C partitioned where kl-heavy shapes replicate it
    # through the layer sum, and keeps every image busy when no square
    # factorization fits the nsplit demand
    pr, pc = _balanced_factor(n)
    if (1, pr, pc) not in cands:
        cands.append((1, pr, pc))
    if long_dim in ("m", "n"):
        ok = [c for c in cands if c[0] <= max(int(nsplit), 1)]
        kl, pr, pc = max(ok)
    else:
        target = max(int(round(n ** (1.0 / 3.0))), 1)
        kl, pr, pc = min(cands, key=lambda c: (abs(c[0] - target), -c[1]))
    if (kl, pr, pc) == (grid.kl, grid.pr, grid.pc):
        return grid
    return Grid((kl, pr, pc), grid.slots)
