"""Double-buffered Cannon ticks: overlap the panel shifts with the tick
products, and measure it.

Counterpart of `dbcsr_tpu/parallel/overlap.py`.  The reference hides
its Cannon panel exchange behind the local block multiplies with async
MPI (``mp_isend``/``mp_irecv`` double-buffered calc/comm sets,
`dbcsr_mm_cannon.F:2977`, `dbcsr_mpiwrap.F:305-421`).  Every engine of
`parallel/` drives its ticks through `run_ticks`:

* **double_buffer** — tick k+1's A/B shifts are posted *first*, against
  a second panel buffer, then tick k's products are launched; across
  ranks the shifts are `isend`/`irecv` handles, between two cards a
  copy on a side CUDA stream, between images of one process on one
  device a hand-over.  Per-tick op order is unchanged, so results are
  **bitwise identical** to the serial order.
* **serial** — each tick's products, then its shift, each drained
  before the next: the bitwise reference.  The JAX package runs it as
  one fused program; here it is the same tick loop in serial order.
* **auto** — double_buffer whenever the grid shifts (square Cannon,
  s > 1, or a multi-chunk all-gather); serial elsewhere.

Measurement: with ``DBCSR_TPU_TORCH_SYNC_TIMING=1`` the loop times the
*exposed* shift wait and the tick products (synchronizing the card
between regions), publishing the measured
``dbcsr_tpu_cannon_overlap_measured{grid,engine,mode}`` gauge — the
comm-exposed fraction, 0.0 = fully hidden — next to the *modeled*
``dbcsr_tpu_cannon_overlap_ratio`` of the cost model, and folding both
into `core.stats`.

Resilience: the per-tick shift edge is a fault-injection site
(``mesh_shift``; ``gather_chunk`` and ``tas_tick`` for the other
engines) and breaker-guarded: a double-buffer failure records against
the ``cannon_db`` (or ``gather_pipe``) pseudo-driver keyed by (engine,
grid), and the multiply re-runs in serial order from the pristine
panels — bitwise identical, so an overlap failure is invisible in the
product.
"""

from __future__ import annotations

import time

import torch

from dbcsr_tpu_torch.core import stats
from dbcsr_tpu_torch.obs import events as _events
from dbcsr_tpu_torch.obs import flight as _flight
from dbcsr_tpu_torch.obs import metrics as _metrics
from dbcsr_tpu_torch.obs import tracer as _trace
from dbcsr_tpu_torch.resilience import faults as _faults

# breaker pseudo-driver of the double-buffered tick pipeline, keyed by
# (engine, grid): its failures route the multiply back to the serial
# order, never condemn the stack kernels themselves; the grouped-TAS
# metronome registers under the same pseudo-driver (engine="tas")
DRIVER = "cannon_db"

# breaker pseudo-driver of the chunked all-gather pipeline on
# rectangular grids: same contract as `cannon_db`
GATHER_DRIVER = "gather_pipe"

MEASURED_GAUGE = "dbcsr_tpu_cannon_overlap_measured"
_MEASURED_HELP = (
    "measured comm-exposed fraction of a distributed multiply's tick "
    "loop (shift wait not hidden behind compute / total tick seconds; "
    "0 = the ring shift fully overlaps the contraction)")


def resolve_mode(engine: str, grid: str, s: int,
                 nticks: int | None = None, driver: str = DRIVER) -> tuple:
    """(mode, why) for one distributed multiply: ``mode`` is
    "double_buffer" or "serial"; ``why`` says who decided (config
    force, auto policy, grid shape, breaker state)."""
    from dbcsr_tpu_torch.core.config import get_config
    from dbcsr_tpu_torch.resilience import breaker as _breaker

    knob = get_config().cannon_overlap
    if s <= 1 or (nticks is not None and nticks <= 1):
        return "serial", "no-ring-shifts"
    if knob == "serial":
        return "serial", "config"
    # allow() claims the half-open trial admission; the caller then runs
    # the double-buffered attempt through `guarded`, whose
    # record_success/record_failure resolves the trial
    if not _breaker.get_board().allow(driver, (engine, grid)):
        return "serial", "breaker-open"
    return "double_buffer", ("config" if knob == "double_buffer" else "auto")


def measuring() -> bool:
    """True when the shift/compute split is timed (the
    ``DBCSR_TPU_TORCH_SYNC_TIMING`` seam, `stats.sync_timing_enabled`)."""
    return stats.sync_timing_enabled()


def use_split_pipeline(mode: str, why: str, measure: bool) -> bool:
    """Should this multiply run the guarded pipeline?  Yes for
    double-buffered ticks, and for the measured serial leg — unless the
    breaker already condemned the pipeline (``why == "breaker-open"``)."""
    return mode == "double_buffer" or (measure and why != "breaker-open")


def _fence() -> None:
    """Wait for the card (the measured regions' boundary)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _local(panels) -> list:
    return [p for p in panels if p is not None]


def _probe(a, b) -> torch.Tensor:
    """The operand panels' permutation-invariant probe (`abft.tree_probe`)
    as one float64 host scalar: this process's images only; a
    multi-process caller sums the ranks' probes."""
    from dbcsr_tpu_torch.acc import abft as _abft

    return torch.tensor(_abft.tree_probe(_local(a) + _local(b)), dtype=torch.float64)


def run_ticks(nticks: int, a, b, c, shift_fn, tick_fn, *, mode: str, engine: str,
              measure: bool = False, driver: str = DRIVER, site: str = "mesh_shift",
              world: bool = False):
    """Drive the Cannon metronome tick by tick.

    ``a`` and ``b`` are the images' panel lists; ``tick_fn(a, b, c, t)
    -> c`` launches tick t's products; ``shift_fn(a, b)`` posts one A/B
    shift and returns a handle whose ``wait()`` gives (a', b').  In
    ``double_buffer`` mode the shift feeding tick t+1 is posted *before*
    tick t's products; in ``serial`` mode each region completes before
    the next.  ``site`` is the fault-injection edge (``mesh_shift``,
    ``gather_chunk`` or ``tas_tick``); ``world`` sums the ABFT shift
    probes over the ranks.

    Returns ``(c, shift_exposed_s, compute_s)``; the timings are 0.0
    unless ``measure``."""
    from dbcsr_tpu_torch.acc import abft as _abft
    from dbcsr_tpu_torch.acc.smm import record_dispatch

    db = mode == "double_buffer"
    inject = db and _faults.active()
    # ABFT shift-conservation probe: a shift is a pure permutation, so
    # the probe of the operand panels is invariant across every shift;
    # finite SDC in a shifted panel breaks it and `guarded` re-runs the
    # serial order (classified ``sdc``).  Probes are evaluated after the
    # loop.
    check_shift = db and _abft.enabled()
    probes = [_probe(a, b)] if check_shift else []
    dtype = next(p for p in _local(a)).dtype if check_shift else None
    nelem = sum(p.numel() for p in _local(a) + _local(b)) if check_shift else 0
    shift_exposed = 0.0
    compute_s = 0.0
    pending = None
    for t in range(nticks):
        if t:
            if db:
                t0 = time.perf_counter()
                a, b = pending.wait()
                if measure:
                    # the exposed remainder of the shift posted last tick
                    _fence()
                    shift_exposed += time.perf_counter() - t0
            else:
                a, b = pending
        last = t == nticks - 1
        if db:
            if not last:
                # the host-level tick/shift boundary: the one place a
                # mid-shift fault can fire
                if inject:
                    _faults.maybe_inject(site, engine=engine, tick=t)
                pending = shift_fn(a, b)
                record_dispatch(driver)
                if inject:
                    pending = _corrupting(pending, site, engine, t)
                if check_shift:
                    pending = _probing(pending, probes)
            c = tick_fn(a, b, c, t)
            record_dispatch(driver)
            if measure:
                t0 = time.perf_counter()
                _fence()
                compute_s += time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            c = tick_fn(a, b, c, t)
            record_dispatch(driver)
            if measure:
                _fence()
                compute_s += time.perf_counter() - t0
            if not last:
                t0 = time.perf_counter()
                pending = shift_fn(a, b).wait()
                record_dispatch(driver)
                if measure:
                    # serial: nothing else is in flight, the whole shift
                    # wait is exposed by construction
                    _fence()
                    shift_exposed += time.perf_counter() - t0
    if len(probes) > 1:
        _check_probes(probes, dtype, nelem, driver, site, world)
    return c, shift_exposed, compute_s


class _corrupting:
    """A shift handle whose result is corrupted at ``site`` when a
    ``nan``/``flip`` fault fires there: the first local A panel is
    cloned (panels may alias the pristine operands) and corrupted."""

    def __init__(self, inner, site, engine, tick):
        self._inner, self._args = inner, (site, engine, tick)

    def wait(self):
        a, b = self._inner.wait()
        site, engine, tick = self._args
        a = list(a)
        i = next(i for i, p in enumerate(a) if p is not None)
        a[i] = _faults.corrupt(site, a[i].clone(), engine=engine, tick=tick)
        return a, b


class _probing:
    """A shift handle that appends the probe of the shifted panels."""

    def __init__(self, inner, probes: list):
        self._inner, self._probes = inner, probes

    def wait(self):
        a, b = self._inner.wait()
        self._probes.append(_probe(a, b))
        return a, b


def _check_probes(probes, dtype, nelem, driver, site, world) -> None:
    """Raise `AbftMismatchError` when a shift did not conserve the probe
    (one evaluation for the whole loop; summed over the ranks)."""
    from dbcsr_tpu_torch.acc import abft as _abft

    vals = torch.stack(probes)
    if world:
        from dbcsr_tpu_torch.parallel import multihost

        vals = sum(torch.as_tensor(v) for v in multihost.all_gather_objects(vals))
    ref = float(vals[0])
    for t, after in enumerate(vals[1:].tolist()):
        if not _abft.shift_conserved(ref, after, dtype, nelem):
            _abft.record_mismatch(driver, site, tick=t, probe_before=ref, probe_after=after)
            raise _abft.AbftMismatchError(
                f"{site} tick {t}: operand-panel probe not conserved across the "
                f"shift ({ref!r} -> {after!r}) — finite silent data corruption "
                f"in a shifted panel")


def checks_enabled() -> bool:
    """Finite-output checking of the double-buffered result: always on
    under fault injection, plus the ``DBCSR_TPU_TORCH_CHECK_OUTPUTS=1``
    opt-in (the acc/smm convention)."""
    from dbcsr_tpu_torch.acc.smm import _output_checks_enabled

    return _output_checks_enabled()


def output_corrupted(out) -> bool:
    """True when an accumulated C panel holds non-finite values."""
    from dbcsr_tpu_torch.acc.smm import _output_corrupted

    tensors = out if isinstance(out, (list, tuple)) else [out]
    return any(t is not None and t.numel() and _output_corrupted(t) for t in tensors)


def guarded(engine: str, grid: str, db_fn, serial_fn, driver: str = DRIVER):
    """Run the double-buffered pipeline with the serial order as the
    bitwise-identical escape hatch: any failure (an injected
    ``mesh_shift``/``gather_chunk``/``tas_tick`` fault, a corrupted
    output, a real error) is classified, recorded against the
    pipeline's breaker pseudo-``driver`` for (engine, grid), surfaced on
    the event bus and the flight record, and the multiply re-runs
    through ``serial_fn()`` from the pristine panels.  Returns
    (result, degraded)."""
    from dbcsr_tpu_torch.resilience import breaker as _breaker

    board = _breaker.get_board()
    key = (engine, grid)
    try:
        out = db_fn()
        if checks_enabled() and output_corrupted(out):
            from dbcsr_tpu_torch.acc.smm import CorruptedOutputError

            raise CorruptedOutputError(
                "double-buffered tick pipeline produced non-finite output panels")
    except Exception as exc:  # noqa: BLE001 -- classified and degraded
        from dbcsr_tpu_torch.acc.smm import (
            _classify_failure,
            _record_driver_failure,
            _record_fallback,
        )

        kind = _classify_failure(exc)
        board.record_failure(driver, key, kind=kind)
        _record_driver_failure(driver, kind, exc, key)
        _record_fallback(driver, "serial", key)
        _trace.annotate(cannon_mode="serial", cannon_degraded=type(exc).__name__)
        _flight.note("cannon_mode", "serial")
        # the rollup's mode says what ran, with no earlier measured sample
        stats.record_cannon_overlap(engine, grid, mode="serial", drop_measured=True)
        out_serial = serial_fn()
        if kind == "sdc":
            from dbcsr_tpu_torch.acc import abft as _abft

            _abft.record_recovery(driver)
        return out_serial, True
    board.record_success(driver, key)
    return out, False


def run_split_pipeline(engine: str, grid: str, mode: str, split_fn, serial_fn,
                       measure: bool, driver: str = DRIVER):
    """Run the tick pipeline guarded, for both modes (the measured
    serial leg shares its failure modes): an open pipeline breaker or a
    failure falls back to ``serial_fn``.  ``split_fn(timings)`` runs the
    pipeline and appends ``(shift_exposed_s, compute_s)``; the measured
    sample is published only when the pipeline delivered the result."""
    if mode != "double_buffer":
        from dbcsr_tpu_torch.resilience import breaker as _breaker

        if not _breaker.get_board().allow(driver, (engine, grid)):
            return serial_fn()
    timings: list = []
    out, degraded = guarded(engine, grid, lambda: split_fn(timings), serial_fn,
                            driver=driver)
    if measure and not degraded and timings:
        publish_measured(engine, grid, mode, *timings[-1])
    return out


def publish_decision(engine: str, grid: str, mode: str, why: str) -> None:
    """Make the overlap decision visible: trace span attributes, the
    flight record and the event bus."""
    _trace.annotate(cannon_mode=mode, cannon_mode_why=why)
    _flight.note("cannon_mode", mode)
    _events.publish("cannon_overlap",
                    {"engine": engine, "grid": grid, "mode": mode, "why": why}, flight=True)
    stats.record_cannon_overlap(engine, grid, mode=mode)


def publish_modeled(engine: str, grid: str, tick: dict) -> None:
    """Per-tick modeled comm/compute gauges, labeled by engine."""
    _metrics.gauge(
        "dbcsr_tpu_cannon_overlap_ratio",
        "modeled comm-time / compute-time per Cannon tick "
        "(<1 = the ring shift hides behind the local contraction)",
    ).set(tick["overlap_ratio"], grid=grid, engine=engine)
    _metrics.gauge(
        "dbcsr_tpu_cannon_tick_comm_bytes",
        "per-image operand bytes ring-shifted per Cannon tick",
    ).set(tick["tick_comm_bytes"], grid=grid, engine=engine)
    _metrics.gauge(
        "dbcsr_tpu_cannon_tick_flops",
        "per-image flops contracted per Cannon tick",
    ).set(tick["tick_flops"], grid=grid, engine=engine)
    stats.record_cannon_overlap(engine, grid, modeled=tick["overlap_ratio"])
    _trace.annotate(cannon_overlap_ratio=round(tick["overlap_ratio"], 4),
                    tick_comm_bytes=tick["tick_comm_bytes"], tick_flops=tick["tick_flops"])


def publish_measured(engine: str, grid: str, mode: str, shift_exposed_s: float,
                     compute_s: float) -> None:
    """Fold one measured tick-loop decomposition into the gauges and the
    `core.stats` overlap rollup: the exposed shift seconds over the
    loop's measured seconds."""
    total = shift_exposed_s + compute_s
    if total <= 0:
        return
    exposed = shift_exposed_s / total
    _metrics.gauge(MEASURED_GAUGE, _MEASURED_HELP).set(exposed, grid=grid, engine=engine,
                                                       mode=mode)
    stats.record_cannon_overlap(engine, grid, mode=mode, measured=exposed,
                                shift_exposed_s=shift_exposed_s, compute_s=compute_s)
    _trace.annotate(cannon_overlap_measured=round(exposed, 4),
                    cannon_shift_exposed_ms=round(shift_exposed_s * 1e3, 3),
                    cannon_compute_ms=round(compute_s * 1e3, 3))
    _flight.note("cannon_overlap_measured", round(exposed, 4))
