"""Declarative service-level objectives, evaluated as multi-window burn
rates over the telemetry history store (`obs.timeseries`).

Counterpart of `dbcsr_tpu/obs/slo.py`, with its four objectives:

=====================  ==============================================
objective              bad when / budget
=====================  ==============================================
``serve_p95_latency``  a tenant's p95 latency sample exceeds
                       ``DBCSR_TPU_TORCH_SLO_SERVE_P95_MS`` (500 ms);
                       budget ``…_P95_BUDGET`` (0.10)
``serve_errors``       shed and deadline-missed requests over the
                       admitted ones; budget
                       ``DBCSR_TPU_TORCH_SLO_SERVE_ERR_BUDGET`` (0.05)
``roofline_floor``     a driver's roofline-fraction sample below
                       ``DBCSR_TPU_TORCH_SLO_ROOFLINE_FLOOR`` (0.002);
                       budget ``…_ROOFLINE_BUDGET`` (0.25)
``abft_unrecovered``   ABFT mismatches not matched by recoveries over
                       probe checks; budget
                       ``DBCSR_TPU_TORCH_SLO_SDC_BUDGET`` (1e-6)
=====================  ==============================================

The two serve objectives read the serving plane (`serve/`): they stay
``NO_DATA`` until it has finished requests.  ``roofline_floor`` reads the store's
``dbcsr_tpu_roofline_fraction``, which holds device-second rates only
(synchronized regions; `obs.timeseries`), on the port's byte convention:
the least bytes a launch moves (`obs.costmodel.stack_min_bytes`), not
the JAX package's per-entry operand gathers, so a port fraction reads
higher than the JAX package's for the same launch and the 0.002 floor
is the looser for it.

A bad fraction is computed over a short window
(``DBCSR_TPU_TORCH_SLO_SHORT_S``, 60 s) and a long one (``…_LONG_S``,
600 s); ``burn = bad_fraction / budget`` per window, and an objective
burns only when both exceed 1.0 (``burn`` = the smaller).  A burn of
``DBCSR_TPU_TORCH_SLO_CRITICAL_BURN`` (8.0) or more is CRITICAL.
Outputs: ``dbcsr_tpu_slo_burn_rate{objective}`` gauges (sampled back
into the store), rising-edge ``slo_burn`` events with
``dbcsr_tpu_slo_burn_total{objective}``, and the ``slo`` component of
`health.verdict()` (`component()`).  Evaluation rides the sampling
cadence (`collect()` from `timeseries.sample()`), never the multiply.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

from dbcsr_tpu_torch.obs import timeseries as _ts

_lock = threading.Lock()


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative objective.

    ``kind``:

    * ``gauge_threshold`` — bad fraction = samples of ``metric``
      violating ``op``/``target`` over all matching series.
    * ``counter_ratio`` — bad fraction = (sum of ``bad_metrics``
      deltas − sum of ``credit_metrics`` deltas, clamped ≥ 0) /
      (sum of ``total_metrics`` deltas) over the window.  Each metric
      entry is a name, or a ``(name, ((label, value), ...))`` pair
      restricting the delta to series matching those labels.
    """
    name: str
    kind: str
    metric: str = ""
    labels: tuple = ()
    op: str = ">"           # gauge_threshold: "bad when value <op> target"
    target_env: str = ""
    target_default: float = 0.0
    budget_env: str = ""
    budget_default: float = 0.1
    bad_metrics: tuple = ()
    credit_metrics: tuple = ()
    total_metrics: tuple = ()

    def target(self) -> float:
        return _env_float(self.target_env, self.target_default) \
            if self.target_env else self.target_default

    def budget(self) -> float:
        b = _env_float(self.budget_env, self.budget_default) \
            if self.budget_env else self.budget_default
        return max(b, 1e-12)


DEFAULT_OBJECTIVES = (
    Objective(
        name="serve_p95_latency", kind="gauge_threshold",
        metric="dbcsr_tpu_serve_latency_p95_ms", op=">",
        target_env="DBCSR_TPU_TORCH_SLO_SERVE_P95_MS", target_default=500.0,
        budget_env="DBCSR_TPU_TORCH_SLO_SERVE_P95_BUDGET", budget_default=0.10),
    Objective(
        name="serve_errors", kind="counter_ratio",
        bad_metrics=("dbcsr_tpu_serve_shed_total",
                     "dbcsr_tpu_serve_deadline_missed_total"),
        # the denominator counts each SUBMISSION exactly once: the
        # requests_total counter also records terminal outcomes (done/
        # failed/...), which would double-count a completed request and
        # halve the burn rate — only the admission outcomes qualify
        total_metrics=(
            ("dbcsr_tpu_serve_requests_total",
             (("outcome", "admitted"),)),
            ("dbcsr_tpu_serve_requests_total",
             (("outcome", "queued_degraded"),)),
            ("dbcsr_tpu_serve_requests_total",
             (("outcome", "shed"),))),
        budget_env="DBCSR_TPU_TORCH_SLO_SERVE_ERR_BUDGET", budget_default=0.05),
    Objective(
        name="roofline_floor", kind="gauge_threshold",
        metric="dbcsr_tpu_roofline_fraction", op="<",
        target_env="DBCSR_TPU_TORCH_SLO_ROOFLINE_FLOOR", target_default=0.002,
        budget_env="DBCSR_TPU_TORCH_SLO_ROOFLINE_BUDGET", budget_default=0.25),
    Objective(
        name="abft_unrecovered", kind="counter_ratio",
        bad_metrics=("dbcsr_tpu_abft_mismatches_total",),
        credit_metrics=("dbcsr_tpu_abft_recoveries_total",),
        total_metrics=("dbcsr_tpu_abft_checks_total",),
        budget_env="DBCSR_TPU_TORCH_SLO_SDC_BUDGET", budget_default=1e-6),
)

# extra objectives registered by embedding apps/tests
_extra: list = []
# rising-edge state + last evaluation (the health component reads it)
_burning: dict = {}
_last_eval: dict = {}
_last_eval_t = 0.0

# minimum samples in a window before a gauge objective may judge it
_MIN_POINTS = 2


def objectives() -> tuple:
    return DEFAULT_OBJECTIVES + tuple(_extra)


def register_objective(obj: Objective) -> None:
    _extra.append(obj)


def reset() -> None:
    global _last_eval_t
    with _lock:
        _burning.clear()
        _last_eval.clear()
        del _extra[:]
        _last_eval_t = 0.0


def windows_s() -> tuple:
    """(short_s, long_s) evaluation windows."""
    short = max(1.0, _env_float("DBCSR_TPU_TORCH_SLO_SHORT_S", 60.0))
    long_ = max(short, _env_float("DBCSR_TPU_TORCH_SLO_LONG_S", 600.0))
    return short, long_


# ---------------------------------------------------------- evaluation

def _gauge_bad_fraction(obj: Objective, since: float,
                        path: str | None) -> tuple:
    """(bad_fraction or None, detail) over one window."""
    total = bad = 0
    offenders: dict = {}
    target, over = obj.target(), obj.op == ">"
    for ser in _ts.query(obj.metric, labels=dict(obj.labels) or None,
                         since=since, path=path, tier="auto"):
        for t, v in ser["points"]:
            total += 1
            violated = v > target if over else v < target
            if violated:
                bad += 1
                key = ",".join(f"{k}={v2}" for k, v2 in
                               sorted(ser["labels"].items())) or "-"
                offenders[key] = offenders.get(key, 0) + 1
    if total < _MIN_POINTS:
        return None, {}
    return bad / total, offenders


def _counter_delta(metric, since: float, path: str | None) -> float:
    """Summed per-series increase of a counter over the window
    (clamped ≥ 0 per series: a reset mid-window must not go negative).
    ``metric`` is a name or a ``(name, labels_pairs)`` restriction."""
    labels = None
    if isinstance(metric, tuple):
        metric, pairs = metric
        labels = dict(pairs)
    out = 0.0
    for ser in _ts.query(metric, labels=labels, since=since, path=path,
                         tier="auto"):
        pts = ser["points"]
        if len(pts) >= 2:
            out += max(0.0, pts[-1][1] - pts[0][1])
    return out


def _ratio_bad_fraction(obj: Objective, since: float,
                        path: str | None) -> tuple:
    total = sum(_counter_delta(m, since, path) for m in obj.total_metrics)
    if total <= 0:
        return None, {}
    bad = sum(_counter_delta(m, since, path) for m in obj.bad_metrics)
    credit = sum(_counter_delta(m, since, path)
                 for m in obj.credit_metrics)
    bad = max(0.0, bad - credit)
    return bad / total, {"bad": bad, "total": total}


def evaluate(now: float | None = None, path: str | None = None) -> dict:
    """Evaluate every objective over the short and long windows.

    Returns ``{name: {"burn", "burn_short", "burn_long",
    "bad_frac_short", "bad_frac_long", "target", "budget", "status",
    "detail"}}``; ``status`` is ``OK``/``BURNING``/``NO_DATA``.  With
    ``path`` the evaluation replays a committed shard family instead
    of the live store (offline analysis — no side effects on the
    rising-edge state)."""
    now = time.time() if now is None else now
    short_s, long_s = windows_s()
    out: dict = {}
    for obj in objectives():
        row: dict = {"target": obj.target() if obj.kind == "gauge_threshold"
                     else None,
                     "budget": obj.budget(), "windows_s": [short_s, long_s]}
        fracs = []
        details = []
        for w in (short_s, long_s):
            since = now - w
            if obj.kind == "gauge_threshold":
                frac, det = _gauge_bad_fraction(obj, since, path)
            else:
                frac, det = _ratio_bad_fraction(obj, since, path)
            fracs.append(frac)
            details.append(det)
        if any(f is None for f in fracs):
            row.update(status="NO_DATA", burn=0.0, burn_short=0.0,
                       burn_long=0.0, bad_frac_short=fracs[0],
                       bad_frac_long=fracs[1], detail=details[0] or {})
            out[obj.name] = row
            continue
        budget = obj.budget()
        burn_short = fracs[0] / budget
        burn_long = fracs[1] / budget
        burn = min(burn_short, burn_long)
        row.update(
            burn=round(burn, 4), burn_short=round(burn_short, 4),
            burn_long=round(burn_long, 4),
            bad_frac_short=round(fracs[0], 6),
            bad_frac_long=round(fracs[1], 6),
            status="BURNING" if burn > 1.0 else "OK",
            detail=details[0] or details[1] or {})
        out[obj.name] = row
    return out


# ------------------------------------------------------ store coupling

def collect(now: float | None = None) -> list:
    """Evaluate against the LIVE store, publish gauges + rising-edge
    ``slo_burn`` events, cache the result for `component()`, and
    return the burn-rate points for `timeseries.sample()` to ingest
    (so burn history persists in the shard next to its inputs)."""
    global _last_eval_t
    now = time.time() if now is None else now
    ev = evaluate(now=now)
    pts = []
    from dbcsr_tpu_torch.obs import metrics as _metrics

    for name, row in ev.items():
        burn = row["burn"]
        _metrics.gauge(
            "dbcsr_tpu_slo_burn_rate",
            "multi-window SLO error-budget burn rate per objective "
            "(min of short/long windows; >1 = budget burning)",
        ).set(burn, objective=name)
        pts.append(("dbcsr_tpu_slo_burn_rate", {"objective": name},
                    burn, _ts.GAUGE))
        _edge(name, row, now)
    with _lock:
        _last_eval.clear()
        _last_eval.update(ev)
        _last_eval_t = now
    return pts


def _edge(name: str, row: dict, now: float) -> None:
    """Rising-edge ``slo_burn`` emission per objective (the anomaly
    detectors' convention: one event + one counter inc per entry into
    the burning state; re-arms below threshold)."""
    burning = row["status"] == "BURNING"
    with _lock:
        was = _burning.get(name, False)
        _burning[name] = burning
    if burning and not was:
        from dbcsr_tpu_torch.obs import events as _events
        from dbcsr_tpu_torch.obs import metrics as _metrics

        _metrics.counter(
            "dbcsr_tpu_slo_burn_total",
            "SLO burn-rate alerts by objective (rising edge)",
        ).inc(objective=name)
        _events.publish("slo_burn", {
            "objective": name, "burn": row["burn"],
            "burn_short": row["burn_short"],
            "burn_long": row["burn_long"], "budget": row["budget"],
            "detail": str(row.get("detail", ""))[:200]}, flight=True)
        # a burn transition is a health transition: force the next
        # sample boundary so the shard records the state change —
        # and arm an incident-bundle capture there (flag-set only)
        _ts.request_sample(f"slo_burn:{name}")
        try:
            from dbcsr_tpu_torch.obs import incidents as _incidents

            _incidents.trigger(f"slo_burn:{name}",
                               {"burn": row["burn"]})
        except Exception:
            pass


def burning() -> dict:
    """{objective: last evaluation row} of objectives currently in the
    burning state."""
    with _lock:
        return {n: dict(_last_eval[n]) for n, on in _burning.items()
                if on and n in _last_eval}


def component() -> dict:
    """The ``slo`` component of `health.verdict()`: DEGRADED while any
    objective burns, CRITICAL at ``DBCSR_TPU_TORCH_SLO_CRITICAL_BURN`` (8x)
    sustained burn; OK (with a reason) when the store is off or no
    evaluation ran yet.  A cached evaluation older than the long
    window is re-evaluated here: sampling is boundary-driven, so an
    idle process would otherwise serve a past burn as CRITICAL forever
    (503ing ``/healthz`` long after the windows drained)."""
    global _last_eval_t

    from dbcsr_tpu_torch.obs import health as _health

    status, reasons = _health.OK, []
    if not _ts.enabled():
        return {"status": status,
                "reasons": ["timeseries store off (DBCSR_TPU_TORCH_TS=0): "
                            "SLOs not evaluated"],
                "objectives": {}}
    crit = _env_float("DBCSR_TPU_TORCH_SLO_CRITICAL_BURN", 8.0)
    now = time.time()
    _, long_s = windows_s()
    with _lock:
        ev = {n: dict(r) for n, r in _last_eval.items()}
        t_eval = _last_eval_t
    if t_eval and now - t_eval > long_s:
        # stale cache: recompute for reporting (no rising-edge side
        # effects — the next collect() owns the edge state)
        ev = evaluate(now=now)
        with _lock:
            _last_eval.clear()
            _last_eval.update(ev)
            _last_eval_t = t_eval = now
    for name, row in sorted(ev.items()):
        if row["status"] != "BURNING":
            continue
        status = _health.DEGRADED
        reasons.append(
            f"objective {name!r} burning its error budget at "
            f"{row['burn']:.1f}x (short {row['burn_short']:.1f}x / "
            f"long {row['burn_long']:.1f}x, budget {row['budget']:g})")
        if row["burn"] >= crit:
            status = _health.CRITICAL
            reasons.append(
                f"{name!r} sustained burn ≥ {crit:g}x: the budget is "
                f"gone within the long window — shed load or roll back")
    return {"status": status, "reasons": reasons, "objectives": ev,
            "t_eval": t_eval or None}
