"""Root-cause attribution: the change ledger and the causal ranker.

Counterpart of `dbcsr_tpu/obs/rca.py`:

* **Change ledger**: a bounded ring (``DBCSR_TPU_TORCH_RCA_LEDGER_N``,
  256) of every system-change event of `LEDGER_KINDS`, fed by an
  `obs.events` subscriber.  ``knob_change`` is synthesized here: the
  config fields of `WATCHED_FIELDS` (``mm_format``, ``mm_driver``,
  ``precision``, ``mm_stack_size``) are polled at every sample boundary,
  and a change becomes a ledger entry and a bus event.  The JAX package
  polls environment variables (``DBCSR_TPU_MM_FORMAT`` …); the port's
  config has none, so its fields are what a run flips.
* **Ranking**: on a regression change-point, each ledger entry within
  ``DBCSR_TPU_TORCH_RCA_WINDOW_S`` (600 s) of the shift scores
  ``weight * exp(-dt / tau) * (1 + label_overlap)`` (an entry after the
  estimated shift counts its distance twice).
* **Report**: the ranked causes, the change-point and the profile diff
  around the shift (`obs.profiler.diff_around`) go to `reports()`,
  ``dbcsr_tpu_rca_reports_total{cause}``, an ``rca_report`` event and an
  incident trigger (``rca:<series>``).

``DBCSR_TPU_TORCH_RCA=0`` turns it off.  Stdlib-only.
"""

from __future__ import annotations

import collections
import math
import os
import threading

_lock = threading.Lock()

# ------------------------------------------------------------ registry
#
# The change-ledger kinds (the JAX package's registry): ``weight`` is
# the ranking prior, how often this change class is the true cause of a
# level shift.

LEDGER_KINDS = {
    "tune_promotion": {
        "weight": 1.0,
        "doc": "autotuner promoted a params row (generation bump)",
    },
    "tune_demotion": {
        "weight": 1.0,
        "doc": "a promoted params row was demoted after live regression",
    },
    "format_decision": {
        "weight": 0.9,
        "doc": "the storage-format planner changed a per-bucket choice",
    },
    "knob_change": {
        "weight": 1.0,
        "doc": "a watched config field changed mid-process",
    },
    "precision_schedule": {
        "weight": 0.8,
        "doc": "the adaptive precision plane (re)scheduled a demotion",
    },
    "precision_promote": {
        "weight": 0.8,
        "doc": "a demoted cell was promoted back to full precision",
    },
    "breaker_transition": {
        "weight": 0.9,
        "doc": "a (driver, shape) circuit breaker changed state",
    },
    "driver_failover": {
        "weight": 0.7,
        "doc": "stacks re-executed on a safer driver after a failure",
    },
    "fleet_failover": {
        "weight": 0.9,
        "doc": "the serve fleet failed a worker's requests over",
    },
    "worker_down": {
        "weight": 0.6,
        "doc": "a serve worker left the fleet (crash or drain)",
    },
    "worker_up": {
        "weight": 0.4,
        "doc": "a serve worker joined the fleet (rolling restart)",
    },
    "incremental_degrade": {
        "weight": 0.8,
        "doc": "the incremental-multiply breaker degraded to full "
               "recompute",
    },
    "multihost_degraded_to_serial": {
        "weight": 0.9,
        "doc": "a world join failed and the engine degraded to serial",
    },
}

# config fields whose mid-process changes are synthesized into the
# ledger (the JAX package watches the environment variables of the
# same settings, `dbcsr_tpu/obs/rca.py:127-132`)
WATCHED_FIELDS = ("mm_format", "mm_driver", "precision", "mm_stack_size")

# payload keys copied into a ledger entry / ranked cause (bounded: a
# ledger entry must stay a small flat dict)
_KEEP_KEYS = ("driver", "mnk", "dtype", "generation", "displaced",
              "reason", "knob", "value", "prev", "format", "shape",
              "state", "from", "to", "worker", "tenant", "gflops",
              "stack_size", "kind")

_REPORT_RING_N = 64


def _env_flag() -> bool:
    return os.environ.get("DBCSR_TPU_TORCH_RCA", "") not in ("0", "off")


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


_enabled = _env_flag()


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Tests / embedding apps: flip attribution without the env var."""
    global _enabled
    _enabled = bool(on)


def window_s() -> float:
    """Attribution window: how far before the shift a change can still
    be a candidate cause."""
    return max(1.0, _env_float("DBCSR_TPU_TORCH_RCA_WINDOW_S", 600.0))


def ledger_n() -> int:
    return max(8, _env_int("DBCSR_TPU_TORCH_RCA_LEDGER_N", 256))


_ledger: collections.deque = collections.deque(maxlen=ledger_n())
_reports: collections.deque = collections.deque(maxlen=_REPORT_RING_N)
_knob_state: dict = {}
_subscribed = False


# ------------------------------------------------------------- ledger

def _entry_of(rec: dict) -> dict:
    ent = {"t": rec.get("t"), "kind": rec.get("event"),
           "product_id": rec.get("product_id")}
    for k in _KEEP_KEYS:
        if k in rec and rec[k] is not None:
            ent[k] = rec[k]
    return ent


def _on_event(rec: dict) -> None:
    """Bus subscriber: admit registered change kinds into the ledger."""
    if not _enabled:
        return
    kind = rec.get("event")
    if kind not in LEDGER_KINDS:
        return
    with _lock:
        _ledger.append(_entry_of(rec))


def _ensure_subscribed() -> None:
    global _subscribed
    if _subscribed:
        return
    try:
        from dbcsr_tpu_torch.obs import events as _events

        _events.subscribe(_on_event)
        _subscribed = True
    except Exception:
        pass


_ensure_subscribed()


def record(kind: str, args: dict | None = None) -> None:
    """Publish a change onto the bus (and thus into the ledger).  The
    path `mm.format_planner` and the knob poll use — every ledger
    entry is a real bus event, so offline event shards replay the same
    ledger the live process had."""
    try:
        from dbcsr_tpu_torch.obs import events as _events

        _events.publish(kind, args or {})
    except Exception:
        pass


def poll_knobs(now: float | None = None) -> None:
    """Diff the watched config fields against their last-seen values; a
    change becomes a ``knob_change`` ledger entry (``knob`` is the
    field's name, ``value`` and ``prev`` its values as strings).  Called
    at every sample boundary (`on_sample`)."""
    if not _enabled:
        return
    from dbcsr_tpu_torch.core.config import get_config

    cfg = get_config()
    for knob in WATCHED_FIELDS:
        cur = str(getattr(cfg, knob))
        with _lock:
            seen = knob in _knob_state
            prev = _knob_state.get(knob)
            _knob_state[knob] = cur
        if seen and cur != prev:
            record("knob_change",
                   {"knob": knob, "value": cur, "prev": prev})


def on_sample(rec: dict) -> None:
    """Sample-boundary hook (`obs.timeseries.sample` tail): poll the
    watched config fields so a mid-run flip is on the ledger BEFORE the
    change-point scan of the same boundary runs."""
    if not _enabled or not rec:
        return
    try:
        poll_knobs(rec.get("t"))
    except Exception:
        pass


# ------------------------------------------------------------- ranking

def _overlap(series_labels: dict, ent: dict) -> int:
    n = 0
    for k, v in (series_labels or {}).items():
        if str(ent.get(k)) == str(v):
            n += 1
    return n


def _score(ent: dict, cp: dict, tau: float) -> float:
    w = LEDGER_KINDS.get(ent.get("kind"), {}).get("weight", 0.5)
    t_shift = cp.get("t_shift") or cp.get("t") or 0.0
    dt = t_shift - (ent.get("t") or 0.0)
    if dt < 0:
        # a cause cannot postdate its effect; tolerate shift-estimate
        # noise with a doubled distance instead of a hard cut
        dt = -dt * 2.0
    proximity = math.exp(-dt / max(tau, 1e-9))
    return w * proximity * (1.0 + _overlap(cp.get("labels"), ent))


def on_changepoint(cp: dict) -> dict | None:
    """Rank candidate causes for one regression change-point and emit
    the causal report.  Called by `obs.changepoint` on the sample
    boundary that detected the shift."""
    if not _enabled:
        return None
    t_shift = cp.get("t_shift") or cp.get("t") or 0.0
    win = window_s()
    tau = win / 5.0
    with _lock:
        candidates = [dict(e) for e in _ledger
                      if (e.get("t") or 0.0) >= t_shift - win]
    ranked = sorted(candidates,
                    key=lambda e: _score(e, cp, tau), reverse=True)
    causes = []
    for i, ent in enumerate(ranked[:5]):
        ent["rank"] = i + 1
        ent["score"] = round(_score(ent, cp, tau), 6)
        causes.append(ent)
    try:
        from dbcsr_tpu_torch.obs import profiler as _profiler

        profile_diff = _profiler.diff_around(t_shift)
    except Exception:
        profile_diff = None
    report = {
        "t": cp.get("t"),
        "changepoint": dict(cp),
        "causes": causes,
        "top_cause": causes[0]["kind"] if causes else None,
        "profile_diff": profile_diff,
    }
    with _lock:
        _reports.append(report)
    _emit(report)
    return report


def _emit(report: dict) -> None:
    cause = report.get("top_cause") or "unknown"
    try:
        from dbcsr_tpu_torch.obs import metrics as _metrics

        _metrics.counter(
            "dbcsr_tpu_rca_reports_total",
            "Ranked causal reports emitted, by top-ranked cause kind",
        ).inc(cause=cause)
    except Exception:
        pass
    cp = report.get("changepoint") or {}
    try:
        from dbcsr_tpu_torch.obs import events as _events

        _events.publish("rca_report", {
            "series": cp.get("series"), "top_cause": cause,
            "n_causes": len(report.get("causes") or ()),
            "magnitude": cp.get("magnitude"),
        })
    except Exception:
        pass
    try:
        from dbcsr_tpu_torch.obs import incidents as _incidents
        from dbcsr_tpu_torch.obs import timeseries as _ts

        _incidents.trigger(f"rca:{cp.get('series')}",
                           {"top_cause": cause,
                            "magnitude": cp.get("magnitude")})
        _ts.request_sample(f"rca:{cp.get('series')}")
    except Exception:
        pass


# --------------------------------------------------------------- reads

def ledger(limit: int | None = None, kind: str | None = None) -> list:
    """Change-ledger entries, oldest first."""
    with _lock:
        out = list(_ledger)
    if kind is not None:
        out = [e for e in out if e.get("kind") == kind]
    if limit is not None and limit >= 0:
        out = out[-limit:]
    return out


def reports(limit: int | None = None) -> list:
    """Ranked causal reports, oldest first."""
    with _lock:
        out = list(_reports)
    if limit is not None and limit >= 0:
        out = out[-limit:]
    return out


def reset() -> None:
    """Drop the ledger, reports and knob state (tests).  The bus
    subscription stays — it is idempotent process state."""
    global _enabled
    with _lock:
        _ledger.clear()
        _reports.clear()
        _knob_state.clear()
    _enabled = _env_flag()
    _ensure_subscribed()
