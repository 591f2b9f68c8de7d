"""Multiplication statistics registry.

Counterpart of `dbcsr_tpu/core/stats.py` (ref the STATISTICS block,
`src/mm/dbcsr_mm_sched.F:390-546`, and marketing against true flops,
`dbcsr_mm.F:664-667`): per-(m,n,k) stacks, entries and flops by driver
and dtype; per-driver flops, modeled bytes (`obs.costmodel`) and
seconds, the rows `obs.metrics` turns into roofline fractions;
marketing flops per multiply; collective traffic; the host and device
memory high-water.  Seconds are host seconds around the launch calls:
dispatch time on the card, unless ``DBCSR_TPU_TORCH_SYNC_TIMING=1``
makes the engine synchronize the card before it reads the clock
(`sync_timing_enabled`; the JAX package blocks on the result).  The
device meter is `torch.cuda.max_memory_allocated` (the JAX package reads
the PJRT allocator's stats).  Everything is gated by the config's
``keep_stats``; `record_stack` and `record_comm` feed the span tracer
when one is active.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import sys

from dbcsr_tpu_torch.obs import tracer as _trace


def _keep() -> bool:
    from dbcsr_tpu_torch.core.config import get_config

    return get_config().keep_stats


@dataclasses.dataclass
class _MnkStat:
    nstacks: int = 0
    nentries: int = 0
    flops: int = 0
    by_driver: dict = dataclasses.field(default_factory=dict)
    # flops by (driver, dtype)
    by_driver_dtype: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _CommStat:
    nmessages: int = 0
    nbytes: int = 0


@dataclasses.dataclass
class _DriverAgg:
    """One driver's flops, modeled bytes and seconds, with its flops by
    dtype (the roofline takes the dominant dtype's peak); ``sync_*``
    hold the same sums over the regions timed after a synchronize only,
    whose seconds are device seconds (the rates `obs.timeseries`,
    `obs.health` and the tuner's miner read)."""
    flops: int = 0
    nbytes: int = 0
    seconds: float = 0.0
    stacks: int = 0
    sync_stacks: int = 0
    sync_flops: int = 0
    sync_nbytes: int = 0
    sync_seconds: float = 0.0
    by_dtype: dict = dataclasses.field(default_factory=dict)


_by_mnk: dict = collections.defaultdict(_MnkStat)
_comm: dict = collections.defaultdict(_CommStat)
_driver_agg: dict = collections.defaultdict(_DriverAgg)
_totals = {"multiplies": 0, "flops": 0, "marketing_flops": 0}


def _agg_driver(driver: str, flops: int, nbytes: int, seconds: float, dtype: str,
                stacks: int, sync: bool = False) -> None:
    agg = _driver_agg[driver]
    agg.flops += flops
    agg.nbytes += nbytes
    agg.seconds += seconds
    agg.stacks += stacks
    if sync:
        agg.sync_stacks += stacks
        agg.sync_flops += flops
        agg.sync_nbytes += nbytes
        agg.sync_seconds += seconds
    if dtype:
        agg.by_dtype[dtype] = agg.by_dtype.get(dtype, 0) + flops


def sync_timing_enabled() -> bool:
    """``DBCSR_TPU_TORCH_SYNC_TIMING=1``: the engine synchronizes the card
    after each stack or fused launch before it reads the clock, so the
    recorded seconds are the device's.  Read per call (once per
    multiply), so a run can switch it."""
    return os.environ.get("DBCSR_TPU_TORCH_SYNC_TIMING") == "1"


def record_driver(driver: str, flops: int, *, nbytes: int = 0, seconds: float = 0.0,
                  dtype: str = "", stacks: int = 1, sync: bool = False) -> None:
    """Charge one executed region (a dense GEMM, a composite batch) to
    its driver: flops, modeled bytes and host seconds (``sync``: the
    seconds end at a synchronize)."""
    if _keep():
        _agg_driver(driver, flops, nbytes, seconds, dtype, stacks, sync=sync)


def driver_rollup() -> dict:
    """The per-driver aggregates as plain dicts."""
    return {d: {"flops": a.flops, "bytes": a.nbytes, "seconds": a.seconds,
                "stacks": a.stacks, "sync_stacks": a.sync_stacks,
                "sync_flops": a.sync_flops, "sync_bytes": a.sync_nbytes,
                "sync_seconds": a.sync_seconds, "by_dtype": dict(a.by_dtype)}
            for d, a in _driver_agg.items()}


def record_stack(m: int, n: int, k: int, nentries: int, *, driver: str,
                 seconds: float | None = None, nbytes: int | None = None,
                 dtype: str = "", sync: bool = False) -> None:
    """One stack's flops by (m, n, k) and driver (the reference's
    BLAS/SMM/ACC split), and its bytes and seconds in the driver's
    rollup; a ``stack`` instant and the open span's ``stack_entries``
    when tracing."""
    if not _keep():
        return
    flops = 2 * m * n * k * nentries
    st = _by_mnk[(m, n, k)]
    st.nstacks += 1
    st.nentries += nentries
    st.flops += flops
    st.by_driver[driver] = st.by_driver.get(driver, 0) + flops
    cell = (driver, dtype)
    st.by_driver_dtype[cell] = st.by_driver_dtype.get(cell, 0) + flops
    _agg_driver(driver, flops, nbytes or 0, seconds or 0.0, dtype, 1, sync=sync)
    t = _trace._tracer
    if t is not None:
        t.instant("stack", {"mnk": f"{m}x{n}x{k}", "entries": nentries, "driver": driver})
        t.add("stack_entries", nentries)


def record_comm(kind: str, nmessages: int, nbytes: int) -> None:
    """Collective traffic by kind (ref the MPI statistics,
    `dbcsr_mm_common.F:135`)."""
    if not _keep():
        return
    st = _comm[kind]
    st.nmessages += int(nmessages)
    st.nbytes += int(nbytes)
    t = _trace._tracer
    if t is not None:
        t.instant(f"comm:{kind}", {"messages": int(nmessages), "bytes": int(nbytes)})
        t.add("comm_bytes", int(nbytes))


def record_multiply(marketing_flops: int) -> None:
    _totals["multiplies"] += 1
    _totals["marketing_flops"] += marketing_flops


# Cannon tick overlap per (engine, grid): the modeled comm/compute ratio
# beside the measured exposed fraction; nothing records it until the
# port's parallel/ exists
_cannon_overlap: dict = {}


def record_cannon_overlap(engine: str, grid: str, *, mode: str | None = None,
                          modeled: float | None = None, measured: float | None = None,
                          shift_exposed_s: float | None = None,
                          compute_s: float | None = None,
                          drop_measured: bool = False) -> None:
    """Merge one multiply's overlap attribution into its (engine, grid)
    cell (latest values win); ``drop_measured`` clears an earlier
    measured sample."""
    if not _keep():
        return
    row = _cannon_overlap.setdefault((engine, grid), {})
    if drop_measured:
        for k in ("measured_exposed", "shift_exposed_s", "compute_s"):
            row.pop(k, None)
    if mode is not None:
        row["mode"] = mode
    if modeled is not None:
        row["modeled_ratio"] = float(modeled)
    if measured is not None:
        row["measured_exposed"] = float(measured)
    if shift_exposed_s is not None:
        row["shift_exposed_s"] = float(shift_exposed_s)
    if compute_s is not None:
        row["compute_s"] = float(compute_s)


def cannon_overlap_rollup() -> dict:
    """{engine: {grid: row}} since the last `reset`."""
    out: dict = {}
    for (engine, grid), row in _cannon_overlap.items():
        out.setdefault(engine, {})[grid] = dict(row)
    return out


# the memory high-water (ref `m_memory`, `dbcsr_machine.F`, and the
# `max_memory` line of `dbcsr_lib.F:326`): the host's VmHWM and VmRSS,
# and on the card the caching allocator's current bytes and its peak
# (since the process started or its caller last reset the allocator's
# peak: `reset` leaves that counter to its owner)
_memory = {"host_peak": 0, "host_current": 0, "device_peak": 0, "device_in_use": 0}
_hwm_at_reset = 0  # VmHWM at the last reset: it only grows


def _read_proc_status(*fields: str):
    """Bytes of the given ``/proc/self/status`` fields (kB there), or None."""
    vals = {f: 0 for f in fields}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                for field in fields:
                    if line.startswith(field):
                        vals[field] = int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        return None
    return tuple(vals[f] for f in fields)


def sample_memory() -> None:
    """Update the high-water meters (end of every multiply): one /proc
    read, and the allocator's counters where CUDA is initialized."""
    if not _keep():
        return
    meters = _read_proc_status("VmHWM:", "VmRSS:")
    if meters is not None:
        hwm, rss = meters
        _memory["host_current"] = rss
        if hwm > _hwm_at_reset:
            _memory["host_peak"] = hwm
        else:  # the peak predates the reset: bound it by the RSS seen since
            _memory["host_peak"] = max(_memory["host_peak"], rss)
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        _memory["device_in_use"] = int(torch.cuda.memory_allocated())
        _memory["device_peak"] = max(_memory["device_peak"],
                                     int(torch.cuda.max_memory_allocated()))


def memory_high_water() -> dict:
    """The meters in bytes (see `sample_memory`)."""
    return dict(_memory)


def total_flops() -> int:
    return sum(s.flops for s in _by_mnk.values())


def reset() -> None:
    global _hwm_at_reset
    _by_mnk.clear()
    _comm.clear()
    _driver_agg.clear()
    _cannon_overlap.clear()
    for k in _totals:
        _totals[k] = 0
    for k in _memory:
        _memory[k] = 0
    meters = _read_proc_status("VmHWM:")
    _hwm_at_reset = meters[0] if meters is not None else 0


def print_statistics(out=print) -> None:
    """The reference's STATISTICS table."""
    out(" " + "-" * 70)
    out(" -" + "DBCSR-TPU STATISTICS".center(68) + "-")
    out(" " + "-" * 70)
    out(f" {'COUNT':>24} {'m x n x k':>14} {'entries':>12} {'GFLOP':>12}  {'drivers'}")
    tot = 0
    for (m, n, k), st in sorted(_by_mnk.items()):
        tot += st.flops
        drv = ",".join(f"{d}={f / 1e9:.2f}" for d, f in sorted(st.by_driver.items()))
        out(f" {st.nstacks:>24} {f'{m}x{n}x{k}':>14} {st.nentries:>12}"
            f" {st.flops / 1e9:>12.3f}  {drv}")
    out(f" {'total (stacks)':>24} {'':>14} {'':>12} {tot / 1e9:>12.3f}")
    out(f" multiplications:       {_totals['multiplies']}")
    out(f" marketing flops:       {_totals['marketing_flops'] / 1e9:.3f} GFLOP")
    if _comm:
        out(" -" + "COLLECTIVE TRAFFIC".center(68) + "-")
        out(f" {'collective':>24} {'messages':>14} {'MB':>12}")
        for kind, st in sorted(_comm.items()):
            out(f" {kind:>24} {st.nmessages:>14} {st.nbytes / 1e6:>12.2f}")
    if _memory["host_peak"]:
        out(" -" + "MEMORY USAGE".center(68) + "-")
        out(f" {'host peak (VmHWM)':>24} {_memory['host_peak'] / 1e6:>14.1f} MB")
        out(f" {'host current (VmRSS)':>24} {_memory['host_current'] / 1e6:>14.1f} MB")
        if _memory["device_peak"]:
            out(f" {'device peak':>24} {_memory['device_peak'] / 1e6:>14.1f} MB")
            out(f" {'device in use':>24} {_memory['device_in_use'] / 1e6:>14.1f} MB")
    out(" " + "-" * 70)
