"""Timer framework: the routine registry of `dbcsr_tpu/core/timings.py`.

Analog of the reference timing subsystem (`src/core/dbcsr_timings.F`:
timeset/timestop handlers with a call stack, per-routine self and
inclusive time; report at `dbcsr_timings_report.F:51`; cachegrind
callgraph export at :303).  A host application can take the timer
over with `set_hooks`, as `dbcsr_base_hooks.F:88-110` allows.

`timed` also opens a `torch.profiler.record_function` range named
``dbcsr_tpu_torch:<name>`` while a profiler records, so a
`torch.profiler` trace shows the engine's regions beside the card's
kernels (the JAX package opens a `jax.profiler.TraceAnnotation`), and
every region but those timed with ``span=False`` is a span of the
tracer (`obs/tracer.py`) when one is active, under the same name.  In
a multi-process world (`parallel/multihost.py`) `report(aggregate=True)`
prints the rank-aggregated table on the coordinator.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

# stdlib-only; one attribute check per region while no tracer is active
from dbcsr_tpu_torch.obs import tracer as _trace


@dataclasses.dataclass
class _RoutineStat:
    calls: int = 0
    total: float = 0.0  # inclusive
    self_time: float = 0.0  # exclusive
    callees: dict = dataclasses.field(default_factory=dict)  # name -> (calls, time)


_stats: dict[str, _RoutineStat] = {}
_stack: list[list] = []  # entries: [name, t_start, child_time]
_hooks = None  # optional (timeset_fn, timestop_fn) override
_generation = 0  # bumped by every `reset`, so a baseline knows it is stale


def set_hooks(timeset_fn, timestop_fn) -> None:
    """Install host-application timer hooks (ref `dbcsr_init_lib_hooks`,
    `dbcsr_base_hooks.F:54-110`); ``set_hooks(None, None)`` restores
    the built-in timer."""
    global _hooks
    _hooks = None if timeset_fn is None and timestop_fn is None else (
        timeset_fn, timestop_fn)


def timeset(name: str, span: bool = True) -> None:
    if _hooks:
        _hooks[0](name)
    _stack.append([name, time.perf_counter(), 0.0])
    if span and not _hooks and _trace._tracer is not None:
        _trace._tracer.begin(name)


def timestop(name: str, span: bool = True) -> float:
    """Close the innermost region, ``name``, and return its seconds; the
    registry is charged with them unless `set_hooks` has taken it over."""
    ent = _stack.pop()
    if ent[0] != name:
        raise RuntimeError(f"timer mismatch: stopped {name}, open {ent[0]}")
    dt = time.perf_counter() - ent[1]
    if _hooks:
        _hooks[1](name)
        return dt
    if span and _trace._tracer is not None:
        _trace._tracer.end(name, dur_s=dt)
    st = _stats.setdefault(name, _RoutineStat())
    st.calls += 1
    st.total += dt
    st.self_time += dt - ent[2]
    if _stack:
        parent = _stack[-1]
        parent[2] += dt
        pst = _stats.setdefault(parent[0], _RoutineStat())
        c, t = pst.callees.get(name, (0, 0.0))
        pst.callees[name] = (c + 1, t + dt)
    return dt


@dataclasses.dataclass
class Region:
    """What `timed` yields: ``seconds``, set at the block's exit, are the
    seconds `timestop` charges to the registry (measured also while
    `set_hooks` has taken the registry over)."""

    seconds: float = 0.0


@contextlib.contextmanager
def timed(name: str, span: bool = True):
    """Host timer, tracer span and profiler range around the block; yields
    a `Region`.  ``span=False``: no tracer span, so the tracer attributes
    written inside go to the enclosing span (a phase split out of it for
    timing).  The profiler range is opened only while a profiler records:
    it costs most of a region's enter and exit and records nothing
    otherwise."""
    region = Region()
    timeset(name, span)
    try:
        if torch.autograd._profiler_enabled():
            with torch.profiler.record_function(f"dbcsr_tpu_torch:{name}"):
                yield region
        else:
            yield region
    finally:
        region.seconds = timestop(name, span)


def reset() -> None:
    global _generation
    _generation += 1
    _stats.clear()
    _stack.clear()
    if _trace._tracer is not None:
        _trace._tracer._span_stack.clear()  # in step with the timer stack


def region_totals() -> tuple:
    """(generation, {name: (calls, inclusive seconds)}) of every region
    timed since the last `reset`; the generation changes at each reset,
    so a reader holding an older baseline counts from zero."""
    return _generation, {name: (st.calls, st.total) for name, st in _stats.items()}


def report(out=print, top: int = 30, aggregate: bool = False) -> None:
    """Per-routine table, self-time ordered (ref timings_report.F:51).

    ``aggregate=True`` in a multi-process world prints the
    rank-aggregated table -- average and max self/total time per routine
    across the ranks -- on the coordinator only; every rank must call it
    (ref the MPI-aggregated report, `dbcsr_timings_report.F:51-301`)."""
    from dbcsr_tpu_torch.parallel import multihost

    if aggregate and multihost.process_count() > 1:
        rows = _aggregate_ranks()
        if rows is None or not multihost.is_coordinator():
            return
        out(" " + "-" * 88)
        out(" -" + f"T I M I N G  ({multihost.process_count()} ranks)".center(86) + "-")
        out(" " + "-" * 88)
        out(f" {'SUBROUTINE':<30} {'CALLS':>8} {'SELF avg':>10} "
            f"{'SELF max':>10} {'TOT avg':>10} {'TOT max':>10}")
        for name, calls, s_avg, s_max, t_avg, t_max in rows[:top]:
            out(f" {name:<30} {calls:>8} {s_avg:>10.3f} {s_max:>10.3f} "
                f"{t_avg:>10.3f} {t_max:>10.3f}")
        out(" " + "-" * 88)
        return
    if not _stats:
        return
    out(" " + "-" * 70)
    out(" -" + "T I M I N G".center(68) + "-")
    out(" " + "-" * 70)
    out(f" {'SUBROUTINE':<36} {'CALLS':>8} {'SELF [s]':>11} {'TOTAL [s]':>11}")
    rows = sorted(_stats.items(), key=lambda kv: -kv[1].self_time)[:top]
    for name, st in rows:
        out(f" {name:<36} {st.calls:>8} {st.self_time:>11.3f} {st.total:>11.3f}")
    out(" " + "-" * 70)


def _aggregate_ranks():
    """Every rank's (name, calls, self, total) rows gathered over the
    world and reduced to per-routine (name, calls, avg self, max self,
    avg total, max total), sorted by average self time; a rank without a
    routine counts 0 in its averages.  None when no rank has timings."""
    from dbcsr_tpu_torch.parallel import multihost

    local = [(name, st.calls, st.self_time, st.total) for name, st in _stats.items()]
    tables = multihost.all_gather_objects(local)
    table: dict = {}
    for rows in tables:
        for name, calls, s, t in rows:
            e = table.setdefault(name, [0, [], []])
            e[0] = max(e[0], int(calls))
            e[1].append(float(s))
            e[2].append(float(t))
    if not table:
        return None
    nproc = len(tables)
    rows = [(name, calls, sum(selfs) / nproc, max(selfs), sum(tots) / nproc, max(tots))
            for name, (calls, selfs, tots) in table.items()]
    rows.sort(key=lambda r: -r[2])
    return rows


def export_callgraph(path: str) -> None:
    """Cachegrind-format callgraph (ref timings_report.F:303-351)."""
    with open(path, "w") as f:
        f.write("events: Walltime_usec\n\n")
        for name, st in _stats.items():
            f.write(f"fn={name}\n1 {int(st.self_time * 1e6)}\n")
            for callee, (calls, t) in st.callees.items():
                f.write(f"cfn={callee}\ncalls={calls} 1\n1 {int(t * 1e6)}\n")
            f.write("\n")
