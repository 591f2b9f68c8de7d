"""Candidate-cell miner: underperforming kernel cells ranked by wasted
FLOP-seconds.

Counterpart of `dbcsr_tpu/tune/miner.py`.  Two sources, merged:

* the live telemetry store (`obs.timeseries`): the per-(driver, mnk,
  dtype) flop cells (``dbcsr_tpu_cell_flops_total``) joined with their
  driver's ``dbcsr_tpu_achieved_gflops`` and
  ``dbcsr_tpu_roofline_fraction``.  The store holds those rates for
  synchronized regions only (device seconds), so a driver whose seconds
  were all dispatch seconds has no rate and none of its cells is mined;
* capture artifacts (``PERF_CAPTURES.jsonl``, ``BENCH_CAPTURES.jsonl``
  at the repo root by default): per-kernel rows whose ``device`` is
  this process's device kind (`obs.costmodel.device_kind`).  A row of
  another device (the committed rows were taken on a TPU) or without a
  device is never mined.

A cell is mined when its roofline fraction is below
``DBCSR_TPU_TORCH_TUNE_FLOOR`` (0.25) or a tuned donor row
(`acc.params.predict`) claims at least 10% more than it achieves.  The
fractions are on the port's byte convention (the least bytes a launch
moves, `obs.costmodel.stack_min_bytes`), under which a launch reads a
higher fraction than under the JAX package's per-entry gathers, so the
0.25 floor mines fewer cells than it would there.  Ranking:
``wasted = flops/1e9 * (1/observed - 1/target)``, at most
``DBCSR_TPU_TORCH_TUNE_MAX_CELLS`` (32) cells
(``dbcsr_tpu_tune_queue_depth``).  `mine_format` ranks the format
planner's mis-crossovers the same way.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

from dbcsr_tpu_torch.tune._env import env_float as _env_float
from dbcsr_tpu_torch.tune._env import env_int as _env_int

_MNK_RE = re.compile(r"^(\d+)x(\d+)x(\d+)$")

# a donor prediction only sets the target when it beats the observed
# rate by this much (noise floor; mirrors the service promotion margin)
_PREDICT_MARGIN = 0.10


def floor() -> float:
    return _env_float("DBCSR_TPU_TORCH_TUNE_FLOOR", 0.25)


def max_cells() -> int:
    return max(1, _env_int("DBCSR_TPU_TORCH_TUNE_MAX_CELLS", 32))


def _predict_gflops(m: int, n: int, k: int, dtype,
                    stack_size: Optional[int]) -> Optional[float]:
    """What tuned evidence (exact or donor row) says this cell can do —
    the miner's target when it beats the observed rate."""
    try:
        from dbcsr_tpu_torch.acc import params as params_mod

        row = params_mod.predict(m, n, k, dtype, stack_size=stack_size)
        if row and row.get("gflops"):
            return float(row["gflops"])
    except Exception:
        pass
    return None


def _production_stack_size() -> int:
    try:
        from dbcsr_tpu_torch.core.config import get_config

        return int(get_config().mm_stack_size)
    except Exception:
        return 30000


def _wasted(flops: float, observed: float, target: float) -> float:
    if observed <= 0 or target <= observed:
        return 0.0
    return flops / 1e9 * (1.0 / observed - 1.0 / target)


def _mine_timeseries(query) -> List[Dict]:
    """Candidates from the live (or replayed) telemetry rings."""
    out: List[Dict] = []
    try:
        cells = query("dbcsr_tpu_cell_flops_total", agg="last")
        ach = {r["labels"].get("driver"): r.get("value")
               for r in query("dbcsr_tpu_achieved_gflops", agg="last")}
        frac = {r["labels"].get("driver"): r.get("value")
                for r in query("dbcsr_tpu_roofline_fraction", agg="last")}
    except Exception:
        return out
    fl = floor()
    stack_size = _production_stack_size()
    for row in cells:
        labels = row.get("labels", {})
        mm = _MNK_RE.match(str(labels.get("mnk", "")))
        driver = labels.get("driver")
        dtype = labels.get("dtype", "float64")
        flops = row.get("value")
        if mm is None or driver is None or not flops:
            continue
        m, n, k = (int(x) for x in mm.groups())
        observed = ach.get(driver)
        f = frac.get(driver)
        if not observed or observed <= 0:
            continue
        predicted = _predict_gflops(m, n, k, dtype, stack_size)
        reasons = []
        target = 0.0
        if f is not None and f < fl:
            # below the floor: the attainable rate at the floor is the
            # minimum acceptable target
            target = observed * fl / max(f, 1e-9)
            reasons.append(f"roofline {f:.4f} < floor {fl}")
        if predicted and predicted > observed * (1.0 + _PREDICT_MARGIN):
            target = max(target, predicted)
            reasons.append(
                f"donor prediction {predicted:.3g} GFLOP/s > observed "
                f"{observed:.3g}")
        if not reasons:
            continue
        out.append({
            "m": m, "n": n, "k": k, "dtype": dtype, "driver": driver,
            "stack_size": stack_size,
            "observed_gflops": round(float(observed), 4),
            "target_gflops": round(float(target), 4),
            "wasted_flop_seconds": _wasted(float(flops), float(observed),
                                           float(target)),
            "flops": float(flops),
            "source": "timeseries",
            "reason": "; ".join(reasons),
        })
    return out


def _capture_rows(path: str) -> List[Dict]:
    rows = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except ValueError:
                    continue  # torn tail line
    except OSError:
        pass
    return rows


def _same_device(row_device, kind: str) -> bool:
    """Whether a capture row's ``device`` ("NVIDIA H100 80GB HBM3", the
    JAX package's "TPU v5 lite0") names this process's device kind: the
    kind, or the kind followed by a device index."""
    norm = [re.sub(r"[\W_]+", "", str(x)).lower() for x in (row_device, kind)]
    return bool(norm[1]) and (norm[0] == norm[1] or (
        norm[0].startswith(norm[1]) and norm[0][len(norm[1]):].isdigit()))


def _mine_captures(paths) -> List[Dict]:
    """Candidates from capture artifacts: per-kernel rows of this
    device kind with a measured GFLOP/s (the acc micro-benchmark's
    schema) whose modeled roofline fraction, or a donor's rate, shows
    headroom."""
    out: List[Dict] = []
    fl = floor()
    from dbcsr_tpu_torch.obs import costmodel

    kind = costmodel.device_kind()
    for path in paths:
        for rec in _capture_rows(path):
            if not _same_device(rec.get("device"), kind):
                continue  # another device's evidence (a TPU row)
            mm = _MNK_RE.match(str(rec.get("kernel", "")))
            gflops = rec.get("gflops") or rec.get("value")
            if mm is None or not isinstance(gflops, (int, float)) \
                    or gflops <= 0:
                continue
            m, n, k = (int(x) for x in mm.groups())
            dtype = str(rec.get("dtype", "float64"))
            stack_size = int(rec.get("stack_size", 0)) or \
                _production_stack_size()
            modeled = rec.get("modeled") or {}
            f = modeled.get("roofline_fraction")
            predicted = _predict_gflops(m, n, k, dtype, stack_size)
            reasons = []
            target = 0.0
            if f is not None and f < fl:
                target = float(gflops) * fl / max(float(f), 1e-9)
                reasons.append(f"roofline {f:.4f} < floor {fl}")
            if predicted and predicted > gflops * (1.0 + _PREDICT_MARGIN):
                target = max(target, predicted)
                reasons.append(
                    f"donor prediction {predicted:.3g} GFLOP/s > "
                    f"measured {gflops:.3g}")
            if not reasons:
                continue
            # one committed row's worth of work is the capture's weight
            flops = 2.0 * m * n * k * stack_size
            out.append({
                "m": m, "n": n, "k": k, "dtype": dtype,
                "driver": rec.get("driver", "auto"),
                "stack_size": stack_size,
                "observed_gflops": round(float(gflops), 4),
                "target_gflops": round(float(target), 4),
                "wasted_flop_seconds": _wasted(flops, float(gflops),
                                               float(target)),
                "flops": flops,
                "source": os.path.basename(path),
                "reason": "; ".join(reasons),
            })
    return out


def _default_capture_paths() -> List[str]:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return [os.path.join(root, "PERF_CAPTURES.jsonl"),
            os.path.join(root, "BENCH_CAPTURES.jsonl")]


def mine_format(limit: Optional[int] = None) -> List[Dict]:
    """Format-axis candidates: block cells whose PLANNED storage
    format underperformed the planner's own cost model
    (`mm.format_planner.mis_crossovers` — measured/predicted below the
    regret floor on the latest sighting).  Same ranking currency as
    kernel cells (wasted FLOP-seconds); the schema adds ``format``/
    ``occ``/``grid`` fields `tune.trials.run_format_trial` consumes.
    Never instantiates the planner: an un-imported planner has no
    regrets to mine."""
    import sys

    fp = sys.modules.get("dbcsr_tpu_torch.mm.format_planner")
    if fp is None:
        return []
    out: List[Dict] = []
    stack_size = _production_stack_size()
    for rec in fp.mis_crossovers():
        cell = rec.get("cell")
        if not cell:
            continue
        bm, bn, bk, dtype = cell
        observed = float(rec.get("measured_gflops") or 0.0)
        target = float(rec.get("predicted_gflops") or 0.0)
        if observed <= 0 or target <= observed:
            continue
        grid = tuple(rec.get("grid") or (1, 1, 1))
        occ = float(rec.get("occ") or 0.0)
        flops = 2.0 * bm * bn * bk * occ * grid[0] * grid[1] * grid[2]
        out.append({
            "m": int(bm), "n": int(bn), "k": int(bk),
            "dtype": str(dtype), "driver": "format",
            "stack_size": stack_size,
            "format": rec.get("format"), "occ": occ,
            "grid": [int(g) for g in grid],
            "observed_gflops": round(observed, 4),
            "target_gflops": round(target, 4),
            "wasted_flop_seconds": _wasted(flops, observed, target),
            "flops": flops,
            "source": "format_planner",
            "reason": (f"format {rec.get('format')} measured/predicted "
                       f"{rec.get('ratio')}"),
        })
    best: Dict[tuple, Dict] = {}
    for c in out:
        key = (c["m"], c["n"], c["k"], c["dtype"])
        cur = best.get(key)
        if cur is None or c["wasted_flop_seconds"] > \
                cur["wasted_flop_seconds"]:
            best[key] = c
    ranked = sorted(best.values(),
                    key=lambda c: -c["wasted_flop_seconds"])
    return ranked[:max_cells() if limit is None else limit]


def mine(limit: Optional[int] = None, query=None,
         capture_paths=None) -> List[Dict]:
    """The ranked candidate-cell queue, most wasted FLOP-seconds first.

    ``query`` defaults to the live `obs.timeseries.query`;
    ``capture_paths`` defaults to the repo's committed capture
    artifacts (pass ``[]`` to mine telemetry only).  Duplicate
    (m, n, k, dtype) cells keep the most-wasteful sighting."""
    if query is None:
        from dbcsr_tpu_torch.obs import timeseries as ts

        query = ts.query
    if capture_paths is None:
        capture_paths = _default_capture_paths()
    cands = _mine_timeseries(query) + _mine_captures(capture_paths)
    best: Dict[tuple, Dict] = {}
    for c in cands:
        key = (c["m"], c["n"], c["k"], c["dtype"])
        cur = best.get(key)
        if cur is None or c["wasted_flop_seconds"] > \
                cur["wasted_flop_seconds"]:
            best[key] = c
    ranked = sorted(best.values(),
                    key=lambda c: -c["wasted_flop_seconds"])
    ranked = ranked[:max_cells() if limit is None else limit]
    try:
        from dbcsr_tpu_torch.obs import metrics

        metrics.gauge(
            "dbcsr_tpu_tune_queue_depth",
            "mined underperforming-cell queue depth (dbcsr_tpu_torch.tune)",
        ).set(len(ranked))
    except Exception:
        pass
    return ranked
