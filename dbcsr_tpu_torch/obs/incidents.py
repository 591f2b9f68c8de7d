"""Incident capture on rising edges: the automatic black-box export.

Counterpart of `dbcsr_tpu/obs/incidents.py`.  When a health detector,
an SLO objective or the causal ranker (`obs.rca`) fires, `trigger()`
arms a capture (a flag only: the health detectors call it under their
lock); the next `timeseries.sample()` calls `on_sample()`, which
assembles the bundle (the events ring, the flight ring, the health
verdict, the tenant usage, the newest RCA report and the sample the
edge forced) and writes it as typed JSONL lines.

Rate limit: at most ``DBCSR_TPU_TORCH_INCIDENT_N`` (8) bundles a
process, no closer than ``DBCSR_TPU_TORCH_INCIDENT_INTERVAL_S`` (60 s)
apart, counted in ``dbcsr_tpu_incident_bundles_total{result}``.
``DBCSR_TPU_TORCH_INCIDENTS`` names the bundle directory; unset (or
``0``) keeps bundles in memory only (`bundles()`): the port writes no
file into the working directory unless asked to (the JAX package
defaults to ``incidents/`` there).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

_lock = threading.Lock()
_pending: "str | None" = None
_pending_args: dict = {}
_last_capture = 0.0
_count = 0
_bundles: list = []  # in-memory ring of (reason, path, bundle) dicts
_BUNDLE_RING = 8
_EVENTS_TAIL = 256


def _dir() -> "str | None":
    v = os.environ.get("DBCSR_TPU_TORCH_INCIDENTS", "")
    return None if v in ("", "0") else v


def _interval_s() -> float:
    try:
        return float(os.environ.get("DBCSR_TPU_TORCH_INCIDENT_INTERVAL_S", "60"))
    except ValueError:
        return 60.0


def _max_bundles() -> int:
    try:
        return int(os.environ.get("DBCSR_TPU_TORCH_INCIDENT_N", "8"))
    except ValueError:
        return 8


def _counter(result: str) -> None:
    try:
        from dbcsr_tpu_torch.obs import metrics as _metrics

        _metrics.counter(
            "dbcsr_tpu_incident_bundles_total",
            "anomaly/SLO-edge incident captures by result "
            "(captured = bundle assembled, suppressed = rate-limited)",
        ).inc(result=result)
    except Exception:
        pass


def trigger(reason: str, args: dict | None = None) -> bool:
    """Arm an incident capture for a rising edge.  Safe to call under
    the health/SLO locks: only sets a flag (plus one counter inc).
    Returns True when armed, False when rate-limited away."""
    global _pending, _pending_args
    now = time.time()
    with _lock:
        if _count >= _max_bundles() or (now - _last_capture
                                        < _interval_s()):
            limited = True
        else:
            limited = False
            if _pending is None:
                _pending = str(reason)
                _pending_args = dict(args or {})
    if limited:
        _counter("suppressed")
    return not limited


def on_sample(sample_rec: dict | None) -> "str | None":
    """Capture boundary (tail of `timeseries.sample()`, no store lock
    held): when a trigger is armed, assemble + persist the bundle.
    Returns the bundle path (None when nothing was armed or
    persistence is off)."""
    global _pending, _pending_args, _last_capture, _count
    with _lock:
        if _pending is None:
            return None
        reason, args = _pending, _pending_args
        _pending, _pending_args = None, {}
        _last_capture = time.time()
        _count += 1
        seq = _count
    bundle = _assemble(reason, args, sample_rec)
    path = _persist(bundle, reason, seq)
    with _lock:
        _bundles.append({"reason": reason, "path": path,
                         "bundle": bundle})
        del _bundles[:-_BUNDLE_RING]
    _counter("captured")
    try:
        from dbcsr_tpu_torch.obs import events as _events

        _events.publish("incident_captured",
                        {"reason": reason, "path": path or ""})
    except Exception:
        pass
    return path


def _assemble(reason: str, args: dict, sample_rec) -> dict:
    """One bundle dict; every layer guarded so a broken collector
    costs its section, not the capture."""
    bundle = {
        "meta": {"kind": "incident", "reason": reason,
                 "args": {k: str(v) for k, v in (args or {}).items()},
                 "t_unix": time.time(), "pid": os.getpid()},
        "sample": sample_rec,
    }
    try:
        from dbcsr_tpu_torch.obs import health as _health

        bundle["health"] = _health.verdict()
    except Exception:
        pass
    try:
        from dbcsr_tpu_torch.obs import events as _events

        bundle["events"] = _events.records(limit=_EVENTS_TAIL)
    except Exception:
        pass
    try:
        from dbcsr_tpu_torch.obs import flight as _flight

        bundle["flight"] = _flight.records()
    except Exception:
        pass
    try:
        from dbcsr_tpu_torch.obs import attribution as _attr

        bundle["usage"] = _attr.usage()
    except Exception:
        pass
    try:
        from dbcsr_tpu_torch.obs import rca as _rca

        reps = _rca.reports(limit=1)
        if reps:
            bundle["rca"] = reps[-1]
    except Exception:
        pass
    return bundle


def _persist(bundle: dict, reason: str, seq: int) -> "str | None":
    """Write the bundle as typed JSONL lines (``rec`` discriminator:
    meta / health / sample / usage / rca / event / flight), the JAX
    package's bundle shape."""
    base = _dir()
    if base is None:
        return None
    tag = re.sub(r"[^A-Za-z0-9_.-]+", "_", reason)[:48] or "incident"
    path = os.path.join(base,
                        f"incident-{tag}-{os.getpid()}-{seq}.jsonl")
    try:
        os.makedirs(base, exist_ok=True)
        with open(path, "w") as fh:
            fh.write(json.dumps(dict(bundle["meta"], rec="meta"),
                                default=str) + "\n")
            for key in ("health", "sample", "usage", "rca"):
                if bundle.get(key) is not None:
                    fh.write(json.dumps({"rec": key, key: bundle[key]},
                                        default=str) + "\n")
            for ev in bundle.get("events") or []:
                fh.write(json.dumps(dict(ev, rec="event"),
                                    default=str) + "\n")
            for fr in bundle.get("flight") or []:
                fh.write(json.dumps(dict(fr, rec="flight"),
                                    default=str) + "\n")
    except Exception:
        return None  # persistence must never break the boundary
    return path


def bundles() -> list:
    """In-memory ring of the bundles captured this process (newest
    last): [{"reason", "path", "bundle"}]."""
    with _lock:
        return list(_bundles)


def pending() -> "str | None":
    with _lock:
        return _pending


def reset() -> None:
    """Clear armed triggers, the capture budget and the in-memory
    ring (wired into `metrics.reset(include_stats=True)` alongside the
    attribution layer)."""
    global _pending, _pending_args, _last_capture, _count
    with _lock:
        _pending, _pending_args = None, {}
        _last_capture = 0.0
        _count = 0
        del _bundles[:]
