"""The multi-process world: `torch.distributed` over the gloo backend.

Counterpart of `dbcsr_tpu/parallel/multihost.py`, which joins a
`jax.distributed` world.  Here each process is one rank of a gloo
group; a grid (`parallel/mesh.Grid`) deals its images over the ranks,
and several ranks may share one card, as CP2K runs several MPI ranks
per GPU.  Panels travel between ranks as host-staged CPU tensors
through point-to-point calls (DBCSR's path without GPU-aware MPI):
NCCL refuses two ranks on one device, and gloo's point-to-point calls
are not relied on for CUDA tensors.

Ref `mp_world_init` / `mp_world_finalize` (`dbcsr_mpiwrap.F:596`); with
no world to join the module keeps single-process semantics (the
reference's `!defined(__parallel)` stubs, `dbcsr_mpiwrap.F:130-150`).

`spawn_world` starts a local world of fresh interpreters (the
``spawn`` start method: nothing forks a process that may hold a CUDA
context), rendezvousing through a ``file://`` store in a temporary
directory, never a fixed TCP port.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import Optional

import torch

from dbcsr_tpu_torch.obs import events as _events
from dbcsr_tpu_torch.resilience import faults as _faults

# host-staged traffic since the last `reset_staged`, by kind: "shift"
# (the point-to-point panel exchanges; seconds from posting an exchange
# to its completion) and "gather" (C's panels broadcast to every rank)
_staged = {"shift": {"bytes": 0, "messages": 0, "seconds": 0.0},
           "gather": {"bytes": 0, "messages": 0, "seconds": 0.0}}


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _is_join_timeout(exc: BaseException) -> bool:
    """Did the rendezvous simply never complete (vs a config error, which
    must keep propagating on explicit cluster specs)?"""
    msg = f"{type(exc).__name__}: {exc}".lower()
    return "deadline_exceeded" in msg or "timed out" in msg or "timeout" in msg


def _note_degraded_to_serial(exc: BaseException, coordinator, timeout_s) -> None:
    """Structured degraded-to-serial record: counter, flight-recorder
    entry, event and a RuntimeWarning."""
    import warnings

    from dbcsr_tpu_torch.obs import flight as _flight
    from dbcsr_tpu_torch.obs import metrics as _metrics

    _metrics.counter(
        "dbcsr_tpu_multihost_degraded_total",
        "world joins that failed/timed out and degraded to serial",
    ).inc(reason="join_timeout" if _is_join_timeout(exc) else "join_error")
    _flight.begin(op="multihost_init", name="init_multihost",
                  coordinator=str(coordinator), timeout_s=timeout_s)
    _flight.commit(error=f"degraded to serial: {type(exc).__name__}: {exc}")
    _events.publish("multihost_degraded_to_serial", {
        "coordinator": str(coordinator), "timeout_s": timeout_s,
        "error": f"{type(exc).__name__}: {exc}"[:300],
    })
    warnings.warn(
        f"multihost world join did not complete within {timeout_s}s "
        f"({type(exc).__name__}: {exc}); DEGRADING TO SERIAL — this "
        f"process will compute alone", RuntimeWarning, stacklevel=3)


def _rebind_obs() -> None:
    """Settle the tracer's, the event sink's and the telemetry store's
    shards on this rank, and move the HTTP endpoint to its ``base +
    rank`` port (`obs.server.rebind`; a no-op when it was never
    asked for)."""
    from dbcsr_tpu_torch.obs import server as _server
    from dbcsr_tpu_torch.obs import timeseries as _timeseries
    from dbcsr_tpu_torch.obs import tracer as _trace

    idx = process_id()
    _events.rebind(idx)
    _timeseries.rebind(idx)
    _server.rebind(idx)
    if _trace.active():
        _trace.rebind(idx)


def _trace_clock_align() -> None:
    """World-join trace bookkeeping (`dbcsr_tpu/parallel/multihost.py:57-93`):
    a ``clock_align`` instant published from behind a world barrier, so
    that every rank's trace shard records the same moment, the anchor
    `tools/trace_merge.py` puts the ranks' clocks on one timeline by.
    Nothing (and no barrier) when tracing is off: turn
    ``DBCSR_TPU_TORCH_TRACE`` on for every rank or for none.  The barrier
    is the gloo world's own (the JAX package's coordination service)."""
    from dbcsr_tpu_torch.obs import tracer as _trace

    if not _trace.active():
        return
    barrier = "none"
    try:
        _dist().barrier()
        barrier = "gloo"
    except Exception:  # noqa: BLE001 -- best effort: t_unix still aligns coarsely
        pass
    _events.publish("clock_align", {
        "barrier": barrier,
        "t_unix": time.time(),
        "process": process_id(),
        "nproc": process_count(),
    })


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   timeout_s: Optional[float] = None) -> bool:
    """Join the world (ref `mp_world_init`) as rank ``process_id`` of
    ``num_processes``, over gloo.

    ``coordinator_address`` is a `torch.distributed` init method
    (``file:///path``, ``tcp://host:port``; a bare ``host:port`` means
    tcp).  With no arguments the torchrun environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``) is used when present; without it
    the call returns False and the process stays single (the serial
    stub).  ``timeout_s`` bounds the join (default
    ``DBCSR_TPU_TORCH_MULTIHOST_TIMEOUT_S``, 300 s): a rendezvous that
    never completes returns False with a counted, flight-recorded
    degraded-to-serial note; any other failure of an explicit spec
    raises.  Callers must check the result: a False join computes on
    one process only."""
    if _faults.active():
        _faults.maybe_inject("multihost_init")
    if timeout_s is None:
        try:
            timeout_s = float(os.environ.get("DBCSR_TPU_TORCH_MULTIHOST_TIMEOUT_S", "300"))
        except ValueError:
            timeout_s = 300.0
    dist = _dist()
    if coordinator_address is None:
        if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            return False  # nothing to join: the quiet serial stub
        method = "env://"
    else:
        method = (coordinator_address if "://" in coordinator_address
                  else f"tcp://{coordinator_address}")
    kwargs = {"backend": "gloo", "init_method": method,
              "timeout": datetime.timedelta(seconds=timeout_s)}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    try:
        dist.init_process_group(**kwargs)
    except Exception as exc:  # noqa: BLE001 -- timeout degrades, the rest raises
        if not _is_join_timeout(exc):
            raise
        _note_degraded_to_serial(exc, method, timeout_s)
        return False
    _rebind_obs()
    _trace_clock_align()
    return True


def shutdown_multihost() -> None:
    """Leave the world (ref `mp_world_finalize`)."""
    if _initialized():
        _dist().destroy_process_group()


def process_count() -> int:
    return _dist().get_world_size() if _initialized() else 1


def process_id() -> int:
    return _dist().get_rank() if _initialized() else 0


def is_coordinator() -> bool:
    """Rank-0 check (the reference's `mynode == 0` print gating)."""
    return process_id() == 0


def make_multihost_grid(layers: Optional[int] = None, images_per_process: int = 1,
                        device=None):
    """The ('kl','pr','pc') grid over every rank's images: rank r owns
    images r * images_per_process .. (r + 1) * images_per_process - 1,
    all on its own ``device`` (default: the default device).  In one
    process this is `make_grid(images_per_process)`."""
    from dbcsr_tpu_torch.device import resolve_device
    from dbcsr_tpu_torch.parallel.mesh import Grid, grid_shape

    dev = resolve_device(device)
    n = process_count() * images_per_process
    kl, pr, pc = grid_shape(n, layers)
    return Grid((kl, pr, pc), [(g // images_per_process, dev) for g in range(n)])


# ------------------------------------------------------------ panel moves
def post_exchange(grid, out: list, sends: list, recvs: list, like: torch.Tensor):
    """Post the point-to-point half of a `Grid.shift`: each send is a
    host copy of a local panel, each receive lands in a host buffer and
    moves to its image's device at `PendingShift.wait`."""
    from dbcsr_tpu_torch.parallel.mesh import PendingShift

    dist = _dist()
    t0 = time.perf_counter()
    handles, bufs, nbytes = [], [], 0
    for t, dst, tag in sends:
        host = t.detach().to("cpu")
        nbytes += host.numel() * host.element_size()
        handles.append(dist.isend(host, dst, tag=tag))
        bufs.append(host)
    pending = []
    for d, src, tag in recvs:
        buf = torch.empty(like.shape, dtype=like.dtype)
        handles.append(dist.irecv(buf, src, tag=tag))
        pending.append((d, buf, grid.device_of(d)))
    return PendingShift(out, handles, pending, staged=(nbytes, t0), sent=bufs)


def gather_images(grid, tensors: list) -> list:
    """Every image's tensor on every rank: each image's owner broadcasts
    a host copy, image by image, in image order (a fixed order, so
    every rank assembles the same bits)."""
    dist = _dist()
    like = next(t for t in tensors if t is not None)
    out = list(tensors)
    t0 = time.perf_counter()
    nbytes = msgs = 0
    for g in range(grid.size):
        owner = grid.slots[g][0]
        if grid.local(g):
            buf = tensors[g].detach().to("cpu")
            nbytes += buf.numel() * buf.element_size() * (process_count() - 1)
            msgs += 1
        else:
            buf = torch.empty(like.shape, dtype=like.dtype)
        dist.broadcast(buf, src=owner)
        if not grid.local(g):
            out[g] = buf.to(grid.home())
    note_staged("gather", nbytes, time.perf_counter() - t0, msgs)
    return out


def note_staged(kind: str, nbytes: int, seconds: float, messages: int) -> None:
    """Count host-staged traffic of ``kind`` ("shift" or "gather")."""
    from dbcsr_tpu_torch.core import stats

    row = _staged[kind]
    row["bytes"] += int(nbytes)
    row["messages"] += int(messages)
    row["seconds"] += float(seconds)
    stats.record_comm(f"host_staged_{kind}", messages, nbytes)


def staged() -> dict:
    """Host-staged bytes, messages and seconds by kind since `reset_staged`."""
    return {k: dict(v) for k, v in _staged.items()}


def reset_staged() -> None:
    for row in _staged.values():
        row.update(bytes=0, messages=0, seconds=0.0)


def all_gather_objects(obj) -> list:
    """Every rank's picklable ``obj``, in rank order ([obj] alone)."""
    if not _initialized():
        return [obj]
    out = [None] * process_count()
    _dist().all_gather_object(out, obj)
    return out


# ------------------------------------------------------------- local worlds
def _world_entry(task: str, rank: int, nproc: int, init: str, args: tuple,
                 timeout_s: float, results) -> None:
    """One spawned rank: join the world, run ``task`` ("module:function",
    called with the args), put (rank, "ok", result) or (rank, "error",
    traceback) on the queue, leave."""
    import importlib

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        if not init_multihost(init, nproc, rank, timeout_s=timeout_s):
            results.put((rank, "error", "world join failed"))
            return
        mod, fn = task.split(":")
        out = getattr(importlib.import_module(mod), fn)(*args)
        results.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 -- reported to the parent, which fails
        results.put((rank, "error", traceback.format_exc()))
    finally:
        shutdown_multihost()


def spawn_world(task: str, nproc: int, args: tuple = (), timeout_s: float = 180.0) -> list:
    """Run ``task`` ("module:function") on every rank of a fresh local
    world of ``nproc`` spawned processes; returns the ranks' results in
    rank order.  Raises when a rank fails or the world does not finish
    within ``timeout_s`` (every process is stopped either way)."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_world_entry,
                             args=(task, r, nproc, init, tuple(args), timeout_s, results))
                 for r in range(nproc)]
        for p in procs:
            p.start()
        got: dict = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < nproc:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{nproc}-rank world did not finish within "
                                       f"{timeout_s:.0f} s (ranks done: {sorted(got)})")
                try:
                    rank, status, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)]
                        raise RuntimeError(f"ranks {dead} exited without a result")
                    continue
                if status != "ok":
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [got[r] for r in range(nproc)]


def sparse_cannon_task(seed: int, nblk: int, bsize: int, occupation: float,
                       images_per_proc: int, device) -> dict:
    """A `spawn_world` task: every rank draws the same operands from
    ``seed`` (``nblk`` blocks of ``bsize`` a side), multiplies them on
    the world's grid and reports C's checksum and value digest, the
    host-staged traffic and its lines of the rank-aggregated timing
    report (the coordinator's only)."""
    import numpy as np

    from dbcsr_tpu_torch.core import timings
    from dbcsr_tpu_torch.core.digests import matrix_value_digest
    from dbcsr_tpu_torch.ops.test_methods import checksum, make_random_matrix
    from dbcsr_tpu_torch.parallel.sparse_dist import sparse_multiply_distributed

    grid = make_multihost_grid(images_per_process=images_per_proc, device=device)
    rng = np.random.default_rng(seed)
    sizes = [bsize] * nblk
    a = make_random_matrix("A", sizes, sizes, occupation=occupation, rng=rng, device=device)
    b = make_random_matrix("B", sizes, sizes, occupation=occupation, rng=rng, device=device)
    reset_staged()
    timings.reset()
    c = sparse_multiply_distributed(1.0, a, b, 0.0, None, grid)
    lines: list = []
    timings.report(out=lines.append, aggregate=True)
    return {"rank": process_id(), "grid": dict(grid.shape), "checksum": checksum(c),
            "digest": matrix_value_digest(c).hex(), "staged": staged(),
            "mode": c._mesh["mode"], "report": lines}
