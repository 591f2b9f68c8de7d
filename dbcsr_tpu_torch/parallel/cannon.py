"""Cannon's algorithm over the ('kl','pr','pc') grid, dense panels.

Counterpart of `dbcsr_tpu/parallel/cannon.py` and a re-design of
`multiply_cannon` (`dbcsr_mm_cannon.F:837`):

* The initial Cannon skew (A row i rotated left by i, B column j
  rotated up by j) places each image's first panels directly: image
  (l, i, j) starts with A's row strip i and k slab l*s + (j+i) % s, and
  B's k slab l*s + (i+j) % s and column strip j.
* The metronome loop (`grouped_k_index DO metronome`, :1345) runs s
  ticks through `overlap.run_ticks`: each image's panel product
  accumulates, then A shifts left along 'pc' and B up along 'pr'.
* The 'kl' axis implements the 2.5D algorithm (`dbcsr_mm_3d.F`): each
  layer contracts a k slab, and C is completed by summing the layers in
  order 0..kl-1 (ref `make_layers_3D_C_reduction`, `dbcsr_mm_3d.F:1037`).

The panel products are plain GEMMs (`torch.matmul`), as the JAX package
computes them in XLA; a float32 GEMM on the card refuses TF32, as the
port's dense format does.
"""

from __future__ import annotations

import numpy as np
import torch

from dbcsr_tpu_torch.core import stats
from dbcsr_tpu_torch.core.timings import timed
from dbcsr_tpu_torch.obs import costmodel as _costmodel
from dbcsr_tpu_torch.obs import tracer as _trace
from dbcsr_tpu_torch.parallel import overlap as _overlap
from dbcsr_tpu_torch.parallel.mesh import Grid


class _Pair:
    """Two shifts in flight (A's and B's); `wait` gives (a', b')."""

    def __init__(self, ha, hb):
        self._ha, self._hb = ha, hb

    def wait(self):
        return self._ha.wait(), self._hb.wait()


def ring_sources(grid: Grid, kind: str) -> list:
    """For each image, the image its panel comes from: "a" shifts left
    along 'pc' ((i, j) receives from (i, j+1)), "b" up along 'pr' ((i, j)
    receives from (i+1, j)), within each layer."""
    src = []
    for g in range(grid.size):
        l, i, j = grid.coords(g)
        if kind == "a":
            src.append(grid.image(l, i, (j + 1) % grid.pc))
        else:
            src.append(grid.image(l, (i + 1) % grid.pr, j))
    return src


def shift_pair(grid: Grid, a: list, b: list, src_a, src_b):
    """Post A's and B's shifts (tags kept apart per operand)."""
    return _Pair(grid.shift(a, src_a, tag=0), grid.shift(b, src_b, tag=grid.size))


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _cannon_dense_ticks(grid: Grid, a, b, kl, s, acc_dtype, mode, measure, timings):
    """The tick loop of the dense Cannon; returns C (M, N) in the
    accumulator dtype on the grid's home device."""
    ms, ns = a.shape[0] // s, b.shape[1] // s
    ks = a.shape[1] // (kl * s)
    a_p: list = [None] * grid.size
    b_p: list = [None] * grid.size
    c_p: list = [None] * grid.size
    for g in grid.local_images():
        l, i, j = grid.coords(g)
        dev = grid.device_of(g)
        ka = l * s + (j + i) % s
        kb = l * s + (i + j) % s
        a_p[g] = a[i * ms:(i + 1) * ms, ka * ks:(ka + 1) * ks].to(dev, acc_dtype)
        b_p[g] = b[kb * ks:(kb + 1) * ks, j * ns:(j + 1) * ns].to(dev, acc_dtype)
        c_p[g] = torch.zeros((ms, ns), dtype=acc_dtype, device=dev)
    src_a, src_b = ring_sources(grid, "a"), ring_sources(grid, "b")

    def shift(aa, bb):
        return shift_pair(grid, aa, bb, src_a, src_b)

    def tick(aa, bb, cc, t):
        for g in grid.local_images():
            cc[g].add_(torch.matmul(aa[g], bb[g]))
        return cc

    c_p, shift_s, comp_s = _overlap.run_ticks(
        s, a_p, b_p, c_p, shift, tick, mode=mode, engine="dense", measure=measure,
        world=grid.multiprocess)
    if measure:
        timings.append((shift_s, comp_s))
    c_all = grid.gather_all(c_p)
    home = grid.home()
    out = torch.empty((a.shape[0], b.shape[1]), dtype=acc_dtype, device=home)
    for i in range(s):
        for j in range(s):
            acc = c_all[grid.image(0, i, j)].to(home)
            for l in range(1, kl):  # 2.5D layer sum, in layer order
                acc = acc + c_all[grid.image(l, i, j)].to(home)
            out[i * ms:(i + 1) * ms, j * ns:(j + 1) * ns] = acc
    return out


def cannon_multiply_dense(grid: Grid, a, b, acc_dtype=None) -> torch.Tensor:
    """C = A @ B with A (M, K), B (K, N) dense (tensors or arrays), over
    the grid: A's row strips over 'pr' and k slabs over ('kl', 'pc'), B's
    k slabs over ('kl', 'pr') and column strips over 'pc'.  Returns C on
    the grid's home device.

    M and N must divide by s = the grid's pr extent, K by kl * s.
    ``acc_dtype`` overrides the accumulator dtype (bfloat16 data
    accumulates in float32, the acc layer's convention)."""
    from dbcsr_tpu_torch.mm.multiply import _check_matmul_precision

    kl, s = grid.kl, grid.pr
    if grid.pc != s:
        raise ValueError(
            "the dense Cannon needs a square ('pr','pc') grid; rectangular grids "
            "are supported by the block-sparse engine (sparse_multiply_distributed, "
            "all-gather path)")
    home = grid.home()
    a = _as_tensor(a, home)
    b = _as_tensor(b, home)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError("inner dims differ")
    if m % s or n % s or k % (kl * s):
        raise ValueError(f"shapes {(m, k, n)} not divisible by grid {(kl, s, s)}")
    acc = acc_dtype or a.dtype
    for g in grid.local_images():
        _check_matmul_precision(acc, grid.device_of(g))
    with timed("cannon_dense"):
        _trace.annotate(m=m, n=n, k=k, kl=kl, s=s)
        # collective-traffic accounting, the JAX package's model: with
        # s > 1 the skew plus s - 1 ticks move every A and B shard s
        # times; kl > 1 adds the layer sum of C
        ndev = kl * s * s
        itemsize = a.element_size()
        if s > 1:
            stats.record_comm("ppermute", 2 * s * ndev, s * (m * k + k * n) * itemsize)
        if kl > 1:
            stats.record_comm("psum", (kl - 1) * s * s, (kl - 1) * m * n * itemsize)
        label = grid.label()
        if s > 1:
            tick = _costmodel.cannon_tick_model(m, n, k, kl, s, itemsize,
                                                str(a.dtype).replace("torch.", ""))
            _overlap.publish_modeled("dense", label, tick)
        mode, why = _overlap.resolve_mode("dense", label, s)
        _overlap.publish_decision("dense", label, mode, why)

        def serial_fn():
            return _cannon_dense_ticks(grid, a, b, kl, s, acc, "serial", False, [])

        measure = s > 1 and _overlap.measuring()
        if _overlap.use_split_pipeline(mode, why, measure):
            return _overlap.run_split_pipeline(
                "dense", label, mode,
                lambda timings: _cannon_dense_ticks(grid, a, b, kl, s, acc, mode, measure,
                                                    timings),
                serial_fn, measure)
        return serial_fn()
