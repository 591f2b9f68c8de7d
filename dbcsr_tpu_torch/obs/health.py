"""Health model: the engine's live signals folded into per-component
OK / DEGRADED / CRITICAL verdicts with machine-readable reasons.

Counterpart of `dbcsr_tpu/obs/health.py`.  `verdict()` answers "is this
process healthy now"; `admission_status()` is the verdict without the
advisory components (``slo``, ``tune``, ``fleet``), the one the tuner's
admission gate keys on.

**Components**

* ``drivers``: the breaker board (`resilience.breaker`): any open or
  half-open breaker degrades.  CRITICAL follows the failover chain the
  breaker's stacks take (`acc.smm.breaker_chain`): for CPU tensors
  (pallas_cross, pallas, torch, host) an open breaker on ``torch``, the
  plain version in the place of the JAX package's safe ``xla``; on the
  card (pallas_cross, pallas), where a stack never gives way to the plain
  version, a shape with no kernel left (K3 and K1 both open, or K1 open
  on a complex shape K3 does not take).  Four or more open breakers are
  critical either way.
* ``watchdog``: wedge streaks per guarded channel
  (``dbcsr_tpu_watchdog_wedge_streak``): 1 degrades, 3 is critical.
* ``engine``: proven numeric corruption (checksum retries classified
  ``deterministic``/``unstable``) is critical; a world join degraded to
  serial or an active fallback, recompile or latency anomaly degrades.
* ``perf``: an active roofline collapse degrades, as do pool thrash
  and a shed storm.
* ``integrity``: ABFT mismatches or chain rollbacks degrade; repeated
  mismatches that escaped recovery are critical
  (``DBCSR_TPU_TORCH_HEALTH_SDC_CRITICAL`` = 3).
* ``slo``, ``tune``, ``fleet``: advisory (`obs.slo.component`, the
  online tuner's failure streak and demotions, the serve fleet's
  workers, empty until the port has a serving plane).

**Anomaly detectors**, over the last ``DBCSR_TPU_TORCH_HEALTH_WINDOW``
(64) multiplies, fed by `events.end_product`, each firing on its rising
edge only (an ``anomaly`` event, ``dbcsr_tpu_anomalies_total{kind}``, a
forced telemetry sample and an incident trigger):

* ``recompile_storm``: first-use kernel validations per multiply over
  the window above 0.5 (``dbcsr_tpu_jit_compiles_total``, the port's
  mirror of the JAX package's XLA specializations: the first multiply of
  a new blocking validates every new shape, so a warm-up can fire it);
* ``fallback_storm``: chain failovers per multiply above 0.25;
* ``dispatch_latency_spike``: a multiply's wall time above
  ``median * (1 + max(0.5, 3*MAD/median))`` of the window;
* ``roofline_collapse``: a driver's roofline fraction of the work one
  multiply added below half the window median.  It reads device seconds
  only (`core.stats._DriverAgg.sync_*`): a multiply whose seconds were
  not synchronized adds nothing to the detector, so dispatch rates on
  the card never feed it;
* ``shed_storm``: the serving plane's shed fraction (fed by
  `observe_serve`).

Thresholds are environment variables (`core.knobs`, owner
``obs/health.py``), read once (`reset` re-reads them); windows are keyed
by multiply count, not wall time.
Stdlib-only at import.
"""

from __future__ import annotations

import collections
import os
import threading
import time

OK = "OK"
DEGRADED = "DEGRADED"
CRITICAL = "CRITICAL"

_RANK = {OK: 0, DEGRADED: 1, CRITICAL: 2}

ANOMALY_KINDS = ("recompile_storm", "fallback_storm",
                 "dispatch_latency_spike", "roofline_collapse",
                 "shed_storm")

_lock = threading.Lock()


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _window_n() -> int:
    return max(8, _env_int("DBCSR_TPU_TORCH_HEALTH_WINDOW", 64))


# minimum samples before any detector may fire (half a window floor)
_MIN_SAMPLES = 8

# rolling per-multiply samples: dicts {dur_ms, recompiles, fallbacks}
_samples: collections.deque = collections.deque(maxlen=_window_n())
# running window sums (updated incrementally on append/evict: the
# storm detectors must not re-sum 64 samples per multiply — the bus-on
# budget is micro-seconds)
_sums = {"recompiles": 0.0, "fallbacks": 0.0}
# latency threshold cache: (median, threshold_ms), refreshed every
# _LAT_REFRESH observes (a full median/MAD pass per multiply is the
# single most expensive part of the naive detector)
_lat_cache: list = [0.0, None, 0]  # [median_ms, threshold_ms, age]
_LAT_REFRESH = 8
# per-driver roofline-fraction history (per-multiply deltas)
_rl_hist: dict = {}
# counter totals at the last observe (for per-multiply deltas)
_last = {"compiles": 0.0, "fallbacks": 0.0}
# per-driver rollup totals at the last observe
_last_rollup: dict = {}
# per-(kind, dtype) peak cache for the roofline observer (peaks_for
# re-reads the environment per call; health samples every multiply)
_peak_cache: dict = {}
# env-tunable thresholds, read once (reset() re-reads; tests that
# monkeypatch a health threshold variable must call health.reset())
_th_cache: dict = {}
# rising-edge state per anomaly kind (roofline keyed per driver)
_active: dict = {}
# serving-plane admission window: 1.0 per shed decision, 0.0 per
# admit (fed by serve.queue via observe_serve) — the shed-storm
# detector's rolling window, keyed by admission count like the
# multiply detectors are keyed by multiply count (clock-free).
# `obs.windows.Window` keeps the shed rate O(1) per decision.
from dbcsr_tpu_torch.obs.windows import Window as _Window  # noqa: E402

_serve_window = _Window(_window_n())

# fleet worker liveness, fed by the serve router's heartbeat loop
# (`serve.router.FleetRouter` via observe_fleet): worker name -> up.
# Empty = this process routes no fleet (the component reads OK).
_fleet_state: dict = {}


def _threshold(name: str, default: float) -> float:
    v = _th_cache.get(name)
    if v is None:
        v = _th_cache[name] = _env_float(name, default)
    return v


# the one median/MAD implementation (perf_gate noise convention) lives
# in obs.windows; re-exported here because every detector below — and
# historical callers — read them as health.median/health.mad
from dbcsr_tpu_torch.obs.windows import mad, median  # noqa: E402,F401


def reset() -> None:
    """Drop the rolling windows, detector states and cached env
    thresholds (tests; paired with `metrics.reset`).  Also clears the
    SLO plane's rising-edge/cached-evaluation state when that module
    is loaded — a stale burning objective must not leak a DEGRADED
    ``slo`` component into the next test."""
    import sys

    slo = sys.modules.get("dbcsr_tpu_torch.obs.slo")
    if slo is not None:
        try:
            slo.reset()
        except Exception:
            pass
    with _lock:
        _samples.clear()
        _sums["recompiles"] = 0.0
        _sums["fallbacks"] = 0.0
        _lat_cache[0], _lat_cache[1], _lat_cache[2] = 0.0, None, 0
        _rl_hist.clear()
        _active.clear()
        _last["compiles"] = 0.0
        _last["fallbacks"] = 0.0
        _last_rollup.clear()
        _peak_cache.clear()
        _th_cache.clear()
        _serve_window.clear()
        _fleet_state.clear()


def _counter_total(name: str) -> float:
    from dbcsr_tpu_torch.obs import metrics

    c = metrics._counters.get(name)
    return float(sum(c.values.values())) if c is not None else 0.0


def _counter_by(name: str) -> dict:
    from dbcsr_tpu_torch.obs import metrics

    c = metrics._counters.get(name)
    return dict(c.values) if c is not None else {}


def _fire(kind: str, state_key, args: dict) -> None:
    """Rising-edge anomaly emission: one bus event + one counter inc
    per entry into the anomalous state."""
    if _active.get(state_key):
        return
    _active[state_key] = True
    from dbcsr_tpu_torch.obs import events as _events
    from dbcsr_tpu_torch.obs import metrics

    metrics.counter(
        "dbcsr_tpu_anomalies_total",
        "health-model anomaly detections by kind",
    ).inc(kind=kind)
    _events.publish("anomaly", dict(args, kind=kind), flight=True)
    try:
        # a health transition forces the telemetry store's NEXT sample
        # boundary (deferred: detectors fire under their own locks and
        # must never re-enter the collectors mid-verdict)
        from dbcsr_tpu_torch.obs import timeseries as _ts

        _ts.request_sample(f"anomaly:{kind}")
    except Exception:
        pass
    try:
        # ...and arms an incident-bundle capture at that same boundary
        # (flag-set only — safe under the detector locks this runs in)
        from dbcsr_tpu_torch.obs import incidents as _incidents

        _incidents.trigger(f"anomaly:{kind}", args)
    except Exception:
        pass


def _clear_state(state_key) -> None:
    _active.pop(state_key, None)


def observe_multiply(dur_ms: float | None = None,
                     error: str | None = None) -> None:
    """Feed one finished multiply into the rolling windows and run the
    anomaly detectors.  Called by `events.end_product` (bus on only);
    micro-second budget: running window sums, a cached latency
    threshold refreshed every `_LAT_REFRESH` observes, and a cached
    peak table — no O(window) pass on the common path."""
    if error is not None:
        # a failed multiply's wall time is chain-walk time, not
        # dispatch latency: keep its recompile/fallback deltas in the
        # storm windows but keep it out of the latency median
        dur_ms = None
    compiles = _counter_total("dbcsr_tpu_jit_compiles_total")
    fallbacks = _counter_total("dbcsr_tpu_driver_fallback_total")
    with _lock:
        if compiles < _last["compiles"] or fallbacks < _last["fallbacks"]:
            # a counter shrank: metrics.reset() ran mid-run — resync
            # the baselines instead of clamping every delta to zero
            # until the fresh counters outgrow the stale totals (which
            # would silently disarm the storm detectors)
            _last["compiles"] = compiles
            _last["fallbacks"] = fallbacks
        d_comp = max(0.0, compiles - _last["compiles"])
        d_fall = max(0.0, fallbacks - _last["fallbacks"])
        _last["compiles"] = compiles
        _last["fallbacks"] = fallbacks
        # -- latency spike: vs the PRIOR window's cached median/MAD
        # threshold (refreshed every _LAT_REFRESH appends — a detector
        # threshold, not a benchmark; staleness of <8 samples is noise)
        n_prior = len(_samples)
        if dur_ms is not None and n_prior >= _MIN_SAMPLES:
            _lat_cache[2] += 1
            if _lat_cache[1] is None or _lat_cache[2] >= _LAT_REFRESH:
                durs = [s["dur_ms"] for s in _samples
                        if s["dur_ms"] is not None]
                med = median(durs) if durs else 0.0
                if med > 0:
                    rel = max(
                        _threshold("DBCSR_TPU_TORCH_HEALTH_LATENCY_RELTOL", 0.5),
                        3.0 * mad(durs) / med)
                    _lat_cache[0] = med
                    _lat_cache[1] = med * (1.0 + rel)
                else:
                    _lat_cache[1] = None
                _lat_cache[2] = 0
        spike_th = _lat_cache[1] if (dur_ms is not None
                                     and n_prior >= _MIN_SAMPLES) else None
        # -- append + running sums (evict before the deque drops it)
        if len(_samples) == _samples.maxlen:
            old = _samples[0]
            _sums["recompiles"] -= old["recompiles"]
            _sums["fallbacks"] -= old["fallbacks"]
        _samples.append({"dur_ms": dur_ms, "recompiles": d_comp,
                         "fallbacks": d_fall})
        _sums["recompiles"] += d_comp
        _sums["fallbacks"] += d_fall
        n = len(_samples)
        sum_comp, sum_fall = _sums["recompiles"], _sums["fallbacks"]
    # -- storms: rate over the window (running sums) ------------------
    if n >= _MIN_SAMPLES:
        rate = sum_comp / n
        th = _threshold("DBCSR_TPU_TORCH_HEALTH_RECOMPILE_RATE", 0.5)
        if rate > th:
            _fire("recompile_storm", "recompile_storm",
                  {"rate_per_multiply": round(rate, 3), "threshold": th,
                   "window": n})
        else:
            _clear_state("recompile_storm")
        rate = sum_fall / n
        th = _threshold("DBCSR_TPU_TORCH_HEALTH_FALLBACK_RATE", 0.25)
        if rate > th:
            _fire("fallback_storm", "fallback_storm",
                  {"rate_per_multiply": round(rate, 3), "threshold": th,
                   "window": n})
        else:
            _clear_state("fallback_storm")
    if spike_th is not None:
        if dur_ms > spike_th:
            _fire("dispatch_latency_spike", "dispatch_latency_spike",
                  {"dur_ms": round(dur_ms, 3),
                   "median_ms": round(_lat_cache[0], 3),
                   "threshold_ms": round(spike_th, 3)})
        else:
            _clear_state("dispatch_latency_spike")
    _observe_roofline()


def _attainable(kind: str, dtype: str, d_fl: float, d_by: float) -> float:
    """min(peak compute, intensity * bandwidth) with the (kind, dtype)
    peak pair cached — `costmodel.peaks_for` re-reads the environment
    per call, too heavy for a per-multiply sample."""
    key = (kind, dtype)
    pk = _peak_cache.get(key)
    if pk is None:
        from dbcsr_tpu_torch.obs import costmodel

        pk = _peak_cache[key] = (costmodel.peak_gflops(kind, dtype),
                                 float(costmodel.peaks_for(kind)["gbs"]))
    peak, gbs = pk
    if d_by > 0:
        return min(peak, (d_fl / d_by) * gbs)
    return peak


def _observe_roofline() -> None:
    """Per-driver roofline fraction of the synchronized work this
    multiply added (delta of the cumulative ``sync_*`` rollup), appended
    to per-driver history; collapse = current below half the window
    median.  Dispatch seconds never enter it."""
    try:
        from dbcsr_tpu_torch.core import stats
        from dbcsr_tpu_torch.obs import costmodel
    except Exception:
        return
    kind = costmodel.device_kind()
    ratio = _threshold("DBCSR_TPU_TORCH_HEALTH_COLLAPSE_RATIO", 0.5)
    with _lock:
        for driver, agg in list(stats._driver_agg.items()):
            prev = _last_rollup.get(driver, (0, 0, 0.0))
            if agg.sync_flops < prev[0]:  # stats.reset() ran mid-run: resync
                _last_rollup[driver] = (agg.sync_flops, agg.sync_nbytes,
                                        agg.sync_seconds)
                continue
            d_fl = agg.sync_flops - prev[0]
            d_by = agg.sync_nbytes - prev[1]
            d_s = agg.sync_seconds - prev[2]
            if d_fl <= 0 or d_s <= 0:
                continue
            _last_rollup[driver] = (agg.sync_flops, agg.sync_nbytes,
                                    agg.sync_seconds)
            dtype = max(agg.by_dtype, key=agg.by_dtype.get) \
                if agg.by_dtype else "float64"
            attainable = _attainable(kind, dtype, d_fl, d_by)
            frac = (d_fl / d_s / 1e9) / attainable if attainable else 0.0
            hist = _rl_hist.setdefault(
                driver, collections.deque(maxlen=_window_n()))
            n_prior = len(hist)
            if n_prior >= _MIN_SAMPLES:
                med = median(hist)
                if med > 1e-6 and frac < ratio * med:
                    _fire("roofline_collapse", ("roofline_collapse", driver),
                          {"driver": driver, "fraction": round(frac, 5),
                           "window_median": round(med, 5),
                           "threshold": round(ratio * med, 5)})
                else:
                    _clear_state(("roofline_collapse", driver))
            hist.append(frac)


def observe_serve(shed: bool) -> None:
    """Feed one serving-plane admission decision into the shed-storm
    window (`serve.queue` calls this for every admit/shed).  Rising
    edge fires when the shed fraction of the last window exceeds
    ``DBCSR_TPU_TORCH_HEALTH_SHED_RATE`` (default 0.25) with at least
    `_MIN_SAMPLES` decisions observed — the same rolling-window,
    rising-edge convention as the four multiply detectors."""
    with _lock:
        _serve_window.append(1.0 if shed else 0.0)
        n = len(_serve_window)
        rate = _serve_window.sum / n if n else 0.0
    if n < _MIN_SAMPLES:
        return
    th = _threshold("DBCSR_TPU_TORCH_HEALTH_SHED_RATE", 0.25)
    if rate > th:
        _fire("shed_storm", "shed_storm",
              {"shed_fraction": round(rate, 3), "threshold": th,
               "window": n})
    else:
        _clear_state("shed_storm")


def active_anomalies() -> dict:
    """{kind: [detail…]} of detectors currently in the anomalous
    state (rising-edge flags, not historical counts)."""
    out: dict = {}
    with _lock:
        for key, on in _active.items():
            if not on:
                continue
            if isinstance(key, tuple):
                out.setdefault(key[0], []).append(key[1])
            else:
                out.setdefault(key, []).append(None)
    return out


# ------------------------------------------------------------- verdict

# the plain version: the safe link of a CPU stack's chain, in the place
# of the JAX package's safe ``xla`` driver
_CPU_BACKSTOP = "torch"


def _chain_of(key: str) -> str:
    """"card" or "cpu": the failover chain the breaker's stacks take
    (`acc.smm.breaker_chain`); a breaker no stack recorded reads as
    "cpu" (the JAX package's rule)."""
    import sys

    smm = sys.modules.get("dbcsr_tpu_torch.acc.smm")
    chain = smm.breaker_chain(key) if smm is not None else None
    return chain or "cpu"


def _card_exhausted(key: str, open_set: set) -> bool:
    """An open breaker on the card that leaves its shape no kernel: K1
    and K3 both open, or K1 open on a complex shape K3 does not take."""
    driver, _, shape = key.partition("|")
    if driver == "pallas":
        return "complex" in shape or f"pallas_cross|{shape}" in open_set
    if driver == "pallas_cross":
        return f"pallas|{shape}" in open_set
    return False


def _eval_drivers() -> dict:
    from dbcsr_tpu_torch.resilience import breaker

    status, reasons = OK, []
    board = breaker._board  # do not CREATE a board just to inspect it
    snap = board.snapshot() if board is not None else {}
    open_keys = [k for k, v in snap.items() if v["state"] == "open"]
    half = [k for k, v in snap.items() if v["state"] == "half_open"]
    if half:
        status = DEGRADED
        reasons.append(f"breaker half-open (trial pending): "
                       f"{', '.join(sorted(half))}")
    if open_keys:
        status = DEGRADED
        reasons.append("breaker open: " + ", ".join(
            f"{k} ({snap[k]['last_kind']})" for k in sorted(open_keys)))
        crit_n = _env_int("DBCSR_TPU_TORCH_HEALTH_BREAKER_CRITICAL_N", 4)
        open_set = set(open_keys)
        exhausted = sorted(k.partition("|")[2] for k in open_keys
                           if _chain_of(k) == "card"
                           and _card_exhausted(k, open_set))
        if any(k.startswith(f"{_CPU_BACKSTOP}|") and _chain_of(k) == "cpu"
               for k in open_keys):
            status = CRITICAL
            reasons.append(f"the safe {_CPU_BACKSTOP} driver itself has an "
                           "open breaker — the failover chain is losing its "
                           "backstop")
        elif exhausted:
            status = CRITICAL
            reasons.append("no hand-written kernel left on the card for "
                           + ", ".join(sorted(set(exhausted)))
                           + " — the card's failover chain has no plain "
                           "fallback")
        elif len(open_keys) >= crit_n:
            status = CRITICAL
            reasons.append(f"{len(open_keys)} breakers open "
                           f"(critical at {crit_n})")
    return {"status": status, "reasons": reasons,
            "open": len(open_keys), "half_open": len(half),
            "tracked": len(snap)}


def _eval_watchdog() -> dict:
    from dbcsr_tpu_torch.obs import metrics

    status, reasons = OK, []
    streaks = {}
    g = metrics._gauges.get("dbcsr_tpu_watchdog_wedge_streak")
    if g is not None:
        for key, v in g.values.items():
            name = dict(key).get("name", "?")
            streaks[name] = v
            if v >= 3:
                status = CRITICAL
                reasons.append(f"channel {name!r} wedged {int(v)}x "
                               f"consecutively (backoff is hours)")
            elif v >= 1:
                if status == OK:
                    status = DEGRADED
                reasons.append(f"channel {name!r} wedge streak {int(v)}")
    return {"status": status, "reasons": reasons, "wedge_streaks": streaks}


def _eval_engine() -> dict:
    status, reasons = OK, []
    retries = _counter_by("dbcsr_tpu_checksum_retry_total")
    for key, v in retries.items():
        outcome = dict(key).get("outcome")
        if outcome in ("deterministic", "unstable") and v:
            status = CRITICAL
            reasons.append(f"checksum retry classified {outcome} "
                           f"({int(v)}x): proven numeric corruption")
    degraded = _counter_total("dbcsr_tpu_multihost_degraded_total")
    if degraded:
        if status == OK:
            status = DEGRADED
        reasons.append(f"{int(degraded)} world join(s) degraded to "
                       f"serial")
    anomalies = active_anomalies()
    for kind in ("recompile_storm", "fallback_storm",
                 "dispatch_latency_spike"):
        if kind in anomalies:
            if status == OK:
                status = DEGRADED
            reasons.append(f"active anomaly: {kind}")
    return {"status": status, "reasons": reasons,
            "fallbacks": _counter_total("dbcsr_tpu_driver_fallback_total"),
            "failures": _counter_total("dbcsr_tpu_driver_failures_total"),
            "faults_injected": _counter_total(
                "dbcsr_tpu_faults_injected_total")}


def _eval_perf() -> dict:
    status, reasons = OK, []
    fractions: dict = {}
    try:
        from dbcsr_tpu_torch.core import stats
        from dbcsr_tpu_torch.obs import costmodel

        kind = costmodel.device_kind()
        for driver, agg in stats.driver_rollup().items():
            if agg["sync_seconds"] <= 0:
                continue  # dispatch seconds give no rate
            dtype = max(agg["by_dtype"], key=agg["by_dtype"].get) \
                if agg["by_dtype"] else "float64"
            fractions[driver] = round(costmodel.roofline(
                agg["sync_flops"], agg["sync_bytes"], agg["sync_seconds"],
                kind=kind, dtype=dtype)["roofline_fraction"], 5)
    except Exception:
        pass
    anomalies = active_anomalies()
    collapsed = anomalies.get("roofline_collapse")
    if collapsed:
        status = DEGRADED
        reasons.append("active roofline collapse: "
                       + ", ".join(str(d) for d in collapsed))
    if "shed_storm" in anomalies:
        # the serving plane is rejecting a large fraction of recent
        # submissions (admission control, quotas, or injected faults):
        # DEGRADED — capacity or quota tuning, not engine corruption
        status = DEGRADED
        reasons.append(
            "active shed storm: the serving plane shed more than "
            f"{_threshold('DBCSR_TPU_TORCH_HEALTH_SHED_RATE', 0.25):.0%} of "
            "the last admission window — raise quotas/queue bound or "
            "add capacity (docs/serving.md#shed-storms)")
    pool = {}
    try:
        from dbcsr_tpu_torch.core import mempool

        pool = mempool.pool_stats()
        requests = pool["hits"] + pool["misses"]
        ev_th = _env_int("DBCSR_TPU_TORCH_HEALTH_POOL_EVICTIONS", 8)
        if (pool["enabled"] and pool["evictions"] >= ev_th
                and requests >= 16
                and pool["hits"] < 0.5 * requests):
            # buffers are being dropped at the budget while checkouts
            # still miss: the byte budget is smaller than the chain's
            # working set, so the pool churns instead of serving
            if status == OK:
                status = DEGRADED
            reasons.append(
                f"memory-pool thrash: {int(pool['evictions'])} budget "
                f"evictions with hit ratio "
                f"{pool['hits'] / max(1, requests):.2f} — the pool's "
                f"byte budget is below the working set (held "
                f"{pool['bytes_held']}/{pool['budget_bytes']} B)")
    except Exception:
        pass
    return {"status": status, "reasons": reasons,
            "roofline_fraction": fractions,
            "pool": {k: pool[k] for k in
                     ("hits", "misses", "returns", "evictions",
                      "bytes_held", "high_water") if k in pool}}


def _eval_integrity() -> dict:
    """The data-integrity component: detected-SDC and recovery
    counters folded into a verdict.  A recovered mismatch still
    degrades — the device produced a wrong finite answer and the next
    one may not be caught; repeated mismatches attributed to one
    driver are critical (deterministic corruption, quarantine-level
    evidence)."""
    status, reasons = OK, []
    mism: dict = {}
    for key, v in _counter_by("dbcsr_tpu_abft_mismatches_total").items():
        d = dict(key).get("driver", "?")
        mism[d] = mism.get(d, 0) + int(v)
    total = sum(mism.values())
    rollbacks = _counter_total("dbcsr_tpu_chain_rollback_total")
    recoveries = _counter_total("dbcsr_tpu_abft_recoveries_total")
    # recoveries pair with mismatches EXCEPT the chain labels, which
    # pair with rollbacks (a chain recompute heals an invariant
    # violation, not a counted probe mismatch)
    recov_sdc = sum(
        float(v) for key, v in _counter_by(
            "dbcsr_tpu_abft_recoveries_total").items()
        if not dict(key).get("driver", "").startswith("chain:"))
    unrecovered = max(0, total - int(recov_sdc))
    if total:
        status = DEGRADED
        reasons.append(
            f"{total} ABFT probe mismatch(es) — detected silent data "
            f"corruption: " + ", ".join(
                f"{d}={n}" for d, n in sorted(mism.items())))
    if rollbacks:
        status = DEGRADED if status == OK else status
        reasons.append(f"{int(rollbacks)} chain-invariant rollback(s) "
                       f"recomputed on the safe engine")
    crit_n = _env_int("DBCSR_TPU_TORCH_HEALTH_SDC_CRITICAL", 3)
    repeat = {d: n for d, n in mism.items() if n >= crit_n}
    # fully-recovered SDC — detect → re-execute → verified — leaves the
    # verdict DEGRADED however often it repeats (the breaker owns
    # quarantining a driver that keeps corrupting); CRITICAL is
    # reserved for corruption that ESCAPED recovery: a wrong answer
    # may have reached a caller
    if unrecovered and (repeat or unrecovered >= crit_n):
        status = CRITICAL
        reasons.append(
            f"{unrecovered} detected-SDC result(s) NOT recovered"
            + (" with repeated mismatches from " + ", ".join(
                f"{d} ({n}x)" for d, n in sorted(repeat.items()))
               if repeat else "")
            + f" (critical at {crit_n} — see docs/resilience.md"
              f"#runbook-silent-data-corruption)")
    return {"status": status, "reasons": reasons,
            "abft_checks": _counter_total("dbcsr_tpu_abft_checks_total"),
            "abft_mismatches": mism,
            "recoveries": recoveries,
            "chain_rollbacks": int(rollbacks),
            "serve_drains": _counter_total("dbcsr_tpu_serve_drain_total"),
            "journal_replayed": _counter_total(
                "dbcsr_tpu_serve_journal_replayed_total")}


def _eval_tune() -> dict:
    """The online autotuner's component (`dbcsr_tpu_torch.tune`): OK while
    idle or never started; DEGRADED on a repeated-trial-failure streak
    or when the last cycle demoted a promoted row (a regression the
    judge caught — the table healed itself, but someone should ask
    why).  Advisory like ``slo``: it pages operators and never closes
    serve admission (a sick tuner must not shed traffic)."""
    import sys

    status, reasons = OK, []
    svc_mod = sys.modules.get("dbcsr_tpu_torch.tune.service")
    svc = svc_mod.current_service() if svc_mod is not None else None
    snap = svc.snapshot() if svc is not None else {}
    streak = int(snap.get("trial_failure_streak", 0))
    if streak >= 3:
        status = DEGRADED
        reasons.append(
            f"{streak} consecutive tuning trials failed "
            f"(last error: {snap.get('last_error')}) — see "
            "docs/autotuning.md#runbook-failing-trials")
    if snap.get("last_cycle_demoted"):
        # its own flag, not last_outcome: a cycle that demoted AND
        # then promoted/failed its trial must still page
        status = DEGRADED
        reasons.append(
            "the last tuner cycle demoted a promoted row: its live "
            "roofline cell regressed (docs/autotuning.md"
            "#demotion-on-regression)")
    trials = {dict(k).get("outcome", "?"): int(v)
              for k, v in _counter_by(
                  "dbcsr_tpu_tune_trials_total").items()}
    return {"status": status, "reasons": reasons,
            "running": bool(snap.get("running")),
            "cycles": int(snap.get("cycles", 0)),
            "queue_depth": int(snap.get("queue_depth", 0)),
            "trials": trials,
            "promotions": int(_counter_total(
                "dbcsr_tpu_tune_promotions_total")),
            "demotions": int(_counter_total(
                "dbcsr_tpu_tune_demotions_total")),
            "params_generation": _params_generation()}


def _params_generation() -> int:
    import sys

    pm = sys.modules.get("dbcsr_tpu_torch.acc.params")
    try:
        return int(pm.generation()) if pm is not None else 0
    except Exception:
        return 0


def observe_fleet(workers: dict) -> None:
    """Router feed: the live worker-liveness map ``{name: up}`` (the
    whole table each heartbeat round — workers that left the fleet
    leave the map, so a drained-and-removed worker stops paging)."""
    with _lock:
        _fleet_state.clear()
        _fleet_state.update({str(k): bool(v) for k, v in workers.items()})


def _eval_fleet() -> dict:
    """The serve fleet's component (fed by `serve.router` heartbeats):
    OK when every known worker is up (or this process routes no
    fleet), DEGRADED when some workers are down (capacity lost, the
    router re-places around them), CRITICAL when ALL are down (no
    routable worker — the fleet serves nothing).  Advisory like
    ``slo``/``tune``: a dead PEER must never close THIS process's own
    admission (docs/serving.md § fleet)."""
    with _lock:
        snap = dict(_fleet_state)
    if not snap:
        return {"status": OK, "reasons": [], "workers": {}}
    down = sorted(w for w, up in snap.items() if not up)
    status, reasons = OK, []
    if down and len(down) == len(snap):
        status = CRITICAL
        reasons.append(
            f"all {len(snap)} fleet workers down ({', '.join(down)}) "
            "— docs/serving.md#runbook-worker-down")
    elif down:
        status = DEGRADED
        reasons.append(
            f"{len(down)}/{len(snap)} fleet workers down "
            f"({', '.join(down)}) — the router routes around them; "
            "docs/serving.md#runbook-worker-down")
    return {"status": status, "reasons": reasons, "workers": snap}


def _eval_slo() -> dict:
    """The SLO plane's component (`obs.slo.component`): error-budget
    burn over the telemetry history store — OK with a reason when the
    store is off or nothing evaluated yet."""
    try:
        from dbcsr_tpu_torch.obs import slo

        return slo.component()
    except Exception:
        return {"status": OK, "reasons": [], "objectives": {}}


def _components(include_slo: bool = True) -> dict:
    """The ONE evaluator list both `verdict` and `admission_status`
    share — adding a component here reaches both automatically (a
    hand-maintained second copy would silently drift)."""
    components = {
        "drivers": _eval_drivers(),
        "watchdog": _eval_watchdog(),
        "engine": _eval_engine(),
        "perf": _eval_perf(),
        "integrity": _eval_integrity(),
    }
    if include_slo:
        # the ADVISORY components: they page operators via the full
        # verdict but must never close serve admission — an SLO burn
        # feeding back into sheds (or a sick background tuner shedding
        # live traffic) would be a positive feedback loop; likewise a
        # dead fleet PEER must not shed this worker's own traffic
        components["slo"] = _eval_slo()
        components["tune"] = _eval_tune()
        components["fleet"] = _eval_fleet()
    return components


def verdict() -> dict:
    """The full health verdict: worst component status + per-component
    reasons + the active anomaly set (the ``/healthz`` payload)."""
    components = _components()
    worst = max((c["status"] for c in components.values()),
                key=_RANK.get)
    from dbcsr_tpu_torch.obs import events as _events

    return {
        "status": worst,
        "components": components,
        "anomalies": active_anomalies(),
        "anomaly_counts": {
            dict(k).get("kind", "?"): v
            for k, v in _counter_by("dbcsr_tpu_anomalies_total").items()},
        "window": len(_samples),
        "bus_enabled": _events.enabled(),
        "t_unix": time.time(),
    }


def admission_status() -> str:
    """The verdict the serving plane's admission control keys on:
    worst of every component EXCEPT the advisory ``slo`` and ``tune``
    pair.  The SLO burn component
    pages operators; it must never close admission — for the serve
    error-budget objective a SHED is itself the bad event, so a
    burn-driven shed would be a positive feedback loop (sheds → error
    burn → CRITICAL → shed everything) that locks the plane shut with
    no exit.  Routing-level reactions (the ``/healthz`` 503, fleet
    placement) still see the full verdict."""
    return max((c["status"]
                for c in _components(include_slo=False).values()),
               key=_RANK.get)


# back-compat friendly alias: "evaluate" reads naturally at call sites
evaluate = verdict
