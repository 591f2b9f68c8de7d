"""Change-point detection over the telemetry store: level shifts, not
thresholds.

Counterpart of `dbcsr_tpu/obs/changepoint.py`.  A window-pair CUSUM
detector runs over the derived series of `SERIES`, each computed from
the points of every `obs.timeseries` sample:

* the first ``DBCSR_TPU_TORCH_CP_REF_N`` (12) samples freeze a baseline
  (median, and MAD scale with a 5% relative floor, `obs.windows`);
* each later sample updates two one-sided CUSUM sums (slack 0.5 sigma);
  past ``DBCSR_TPU_TORCH_CP_H`` (8) sigmas the series has shifted;
* the change-point carries the estimated shift time (the start of the
  excursion, not the detection) and its magnitude (new level minus
  baseline), then the detector re-baselines on the new level.

Shifts in a series' regressing direction go to `obs.rca.on_changepoint`;
improvements are recorded (`changepoints()`,
``dbcsr_tpu_changepoints_total{series}``) only.  The series read the
store's device rates (`obs.timeseries`) and the profile's wall totals
(``multiply_latency_ms``).  ``DBCSR_TPU_TORCH_CHANGEPOINT=0`` turns it
off.  Stdlib-only.
"""

from __future__ import annotations

import collections
import math
import os
import threading

from dbcsr_tpu_torch.obs import windows as _win

_lock = threading.Lock()

# ------------------------------------------------------------ registry
#
# The derived change-point series (the JAX package's registry).  Forms:
#
# * "gauge": one detector cell per distinct label set of ``metric``.
# * "ratio": delta(num) / delta(den) between consecutive samples,
#   summed across label rows (``num_match`` filters numerator rows by
#   label subset); one global detector cell, emitted only when the
#   denominator moved.

SERIES = {
    "multiply_latency_ms": {
        "form": "ratio",
        "num": "dbcsr_tpu_multiply_seconds_total",
        "num_match": None,
        "den": "dbcsr_tpu_profiled_multiplies_total",
        "scale": 1000.0,
        "regress": "up",
        "doc": "wall ms per multiply from the continuous profile "
               "baseline's monotonic totals (delta seconds over delta "
               "profiled multiplies between samples; both halves "
               "freeze together when profiling is disabled)",
    },
    "achieved_gflops": {
        "form": "gauge",
        "metric": "dbcsr_tpu_achieved_gflops",
        "regress": "down",
        "doc": "per-driver achieved GFLOP/s from the roofline rollup",
    },
    "roofline_fraction": {
        "form": "gauge",
        "metric": "dbcsr_tpu_roofline_fraction",
        "regress": "down",
        "doc": "per-driver achieved fraction of the roofline",
    },
    "fallback_rate": {
        "form": "ratio",
        "num": "dbcsr_tpu_driver_fallback_total",
        "num_match": None,
        "den": "dbcsr_tpu_multiplies_total",
        "scale": 1.0,
        "regress": "up",
        "doc": "driver fallbacks per multiply (chain failovers)",
    },
    "plan_cache_hit_rate": {
        "form": "ratio",
        "num": "dbcsr_tpu_plan_cache_total",
        "num_match": {"result": "hit"},
        "den": "dbcsr_tpu_plan_cache_total",
        "scale": 1.0,
        "regress": "down",
        "doc": "stack-plan cache hit fraction between samples",
    },
    "serve_p95_latency_ms": {
        "form": "gauge",
        "metric": "dbcsr_tpu_serve_latency_p95_ms",
        "regress": "up",
        "doc": "per-tenant serve p95 latency gauge",
    },
}

_CUSUM_K = 0.5          # CUSUM slack, in sigmas
_RING_N = 256           # fired change-points kept for /rca + doctor
# relative sigma floor: a perfectly quiet reference window must not
# make 1e-12 jitter look like an 8-sigma shift
_REL_SIGMA_FLOOR = 0.05
_ABS_SIGMA_FLOOR = 1e-9


def _env_flag() -> bool:
    return os.environ.get("DBCSR_TPU_TORCH_CHANGEPOINT", "") not in ("0", "off")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


_enabled = _env_flag()


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Tests / embedding apps: flip detection without the env var."""
    global _enabled
    _enabled = bool(on)


def ref_n() -> int:
    """Reference-window length (samples) frozen into the baseline."""
    return max(4, _env_int("DBCSR_TPU_TORCH_CP_REF_N", 12))


def threshold_h() -> float:
    """CUSUM decision threshold, in baseline sigmas."""
    return max(1.0, _env_float("DBCSR_TPU_TORCH_CP_H", 8.0))


# ---------------------------------------------------------------- state

class _Cell:
    """Detector state for one (series, labels) cell."""

    __slots__ = ("ref", "mu", "sigma", "pos", "neg", "exc_t",
                 "exc_vals", "n")

    def __init__(self):
        self.ref: list = []      # warmup samples, then frozen
        self.mu = None           # baseline level (None = warming up)
        self.sigma = 0.0
        self.pos = 0.0           # one-sided CUSUM accumulators
        self.neg = 0.0
        self.exc_t = None        # start of the live excursion
        self.exc_vals: collections.deque = collections.deque(maxlen=64)
        self.n = 0


_cells: dict = {}                       # (series, labels_key) -> _Cell
_changepoints: collections.deque = collections.deque(maxlen=_RING_N)
_prev_counters: dict = {}               # ratio state: key -> (num, den)


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _freeze(cell: _Cell) -> None:
    """Freeze the reference window into (mu, sigma) and arm CUSUM."""
    cell.mu = _win.median(cell.ref)
    scale = _win.mad(cell.ref) * 1.4826
    cell.sigma = max(scale, abs(cell.mu) * _REL_SIGMA_FLOOR,
                     _ABS_SIGMA_FLOOR)
    cell.pos = cell.neg = 0.0
    cell.exc_t = None
    cell.exc_vals.clear()


def observe(series: str, labels: dict, t: float, value: float):
    """Feed one derived sample into the (series, labels) detector.

    Returns the fired change-point dict, or None.  Public so tests and
    replay tooling can drive the detector directly; `on_sample` is the
    production entry point."""
    if not _enabled or series not in SERIES:
        return None
    value = float(value)
    if not math.isfinite(value):
        return None
    spec = SERIES[series]
    key = (series, _labels_key(labels))
    with _lock:
        cell = _cells.get(key)
        if cell is None:
            cell = _cells[key] = _Cell()
        cell.n += 1
        if cell.mu is None:
            cell.ref.append(value)
            if len(cell.ref) >= ref_n():
                _freeze(cell)
            return None
        z = (value - cell.mu) / cell.sigma
        was_quiet = cell.pos == 0.0 and cell.neg == 0.0
        cell.pos = max(0.0, cell.pos + z - _CUSUM_K)
        cell.neg = max(0.0, cell.neg - z - _CUSUM_K)
        if cell.pos == 0.0 and cell.neg == 0.0:
            cell.exc_t = None
            cell.exc_vals.clear()
            return None
        if was_quiet:
            cell.exc_t = t          # excursion start = shift estimate
            cell.exc_vals.clear()
        cell.exc_vals.append(value)
        h = threshold_h()
        if cell.pos <= h and cell.neg <= h:
            return None
        direction = "up" if cell.pos > h else "down"
        level = sum(cell.exc_vals) / len(cell.exc_vals)
        cp = {
            "series": series,
            "labels": dict(labels),
            "t": t,
            "t_shift": cell.exc_t if cell.exc_t is not None else t,
            "direction": direction,
            "baseline": cell.mu,
            "level": level,
            "magnitude": level - cell.mu,
            "sigma": cell.sigma,
            "regression": direction == spec["regress"],
            "n": cell.n,
        }
        # re-baseline onto the new level: no re-fire while the shift
        # persists, automatic re-arm for the eventual recovery
        cell.ref = list(cell.exc_vals)[-ref_n():]
        if len(cell.ref) >= min(ref_n(), 4):
            _freeze(cell)
        else:
            cell.mu = None
            cell.pos = cell.neg = 0.0
            cell.exc_t = None
            cell.exc_vals.clear()
        _changepoints.append(cp)
    _emit(cp)
    return cp


def _emit(cp: dict) -> None:
    """Counter + bus event + RCA hand-off, all guarded: detection must
    never fail the sample boundary that hosts it."""
    try:
        from dbcsr_tpu_torch.obs import metrics as _metrics

        _metrics.counter(
            "dbcsr_tpu_changepoints_total",
            "Change-point detections (level shifts) per derived series",
        ).inc(series=cp["series"])
    except Exception:
        pass
    try:
        from dbcsr_tpu_torch.obs import events as _events

        _events.publish("changepoint", {
            "series": cp["series"], "labels": cp["labels"],
            "direction": cp["direction"], "t_shift": cp["t_shift"],
            "magnitude": cp["magnitude"], "baseline": cp["baseline"],
            "level": cp["level"], "regression": cp["regression"],
        })
    except Exception:
        pass
    if cp["regression"]:
        try:
            from dbcsr_tpu_torch.obs import rca as _rca

            _rca.on_changepoint(cp)
        except Exception:
            pass


# ------------------------------------------------------ sample scanning

def _index_points(points) -> dict:
    idx: dict = {}
    for p in points:
        try:
            metric, labels, value, _kind = p
        except (TypeError, ValueError):
            continue
        idx.setdefault(metric, []).append((labels or {}, value))
    return idx


def _match(labels: dict, want) -> bool:
    if not want:
        return True
    return all(str(labels.get(k)) == str(v) for k, v in want.items())


def on_sample(rec: dict) -> None:
    """Scan one `obs.timeseries` sample record: derive every registered
    series and feed the detectors.  Called at the sampler's tail,
    outside the store lock."""
    if not _enabled or not rec:
        return
    t = rec.get("t", 0.0)
    idx = _index_points(rec.get("points") or [])
    for name, spec in SERIES.items():
        try:
            if spec["form"] == "gauge":
                for labels, value in idx.get(spec["metric"], []):
                    observe(name, labels, t, value)
                continue
            num = sum(v for lb, v in idx.get(spec["num"], [])
                      if _match(lb, spec.get("num_match")))
            den = sum(v for _lb, v in idx.get(spec["den"], []))
            if not idx.get(spec["den"]):
                continue
            with _lock:
                prev = _prev_counters.get(name)
                _prev_counters[name] = (num, den)
            if prev is None:
                continue
            dden = den - prev[1]
            if dden <= 0:
                continue
            dnum = max(0.0, num - prev[0])
            observe(name, {}, t, dnum / dden * spec.get("scale", 1.0))
        except Exception:
            pass  # one broken series must not drop the others


# --------------------------------------------------------------- reads

def changepoints(limit: int | None = None, series: str | None = None,
                 regressions_only: bool = False) -> list:
    """Fired change-points, oldest first."""
    with _lock:
        out = list(_changepoints)
    if series is not None:
        out = [c for c in out if c["series"] == series]
    if regressions_only:
        out = [c for c in out if c["regression"]]
    if limit is not None and limit >= 0:
        out = out[-limit:]
    return out


def state() -> dict:
    """Per-cell detector state summary (doctor / tests)."""
    with _lock:
        return {
            f"{s}|{dict(k)}": {
                "n": c.n, "baseline": c.mu, "sigma": c.sigma,
                "cusum_pos": c.pos, "cusum_neg": c.neg,
                "warmed": c.mu is not None,
            }
            for (s, k), c in _cells.items()
        }


def reset() -> None:
    """Drop all detector state and fired change-points (tests)."""
    global _enabled
    with _lock:
        _cells.clear()
        _changepoints.clear()
        _prev_counters.clear()
    _enabled = _env_flag()
