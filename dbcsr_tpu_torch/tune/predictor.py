"""Transfer and a learned fallback for untuned cells.

Counterpart of `dbcsr_tpu/tune/predictor.py`, with its evidence order
(`lookup_extended`):

1. real evidence: `acc.params.predict` (an exact or donor row of this
   device kind's table) always wins;
2. cross-device transfer: the nearest same-dtype row of another device
   kind's table, its GFLOP/s scaled by the two kinds' peak ratio
   (`obs.costmodel.peak_gflops`);
3. a per-driver ridge regression over (log flops, log stack size,
   intensity, dtype width), trained on this kind's rows and the
   promotion ledger's trial candidates (closed-form normal equations).

The transfer reads only the tables in the port's own parameter
directory (`acc.params._params_dir`, ``DBCSR_TPU_TORCH_PARAMS_DIR``),
never the JAX package's ``dbcsr_tpu/acc/params/``: those rows were
timed on a TPU.  Every row votes (the port's tables have no "onchip"
provenance rule).  `format_prior` is the format planner's donor: the
nearest same-kind row carrying learned format columns.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
from typing import Dict, List, Optional

_FILE_RE = re.compile(r"^parameters_(.+)\.json$")

# donor shapes farther than this flop-count ratio get no opinion
# (params.predict's convention)
_MAX_FLOP_RATIO = 16.0


# ------------------------------------------------------------ transfer

def _kind_tables(exclude_kind: str) -> Dict[str, List[Dict]]:
    """Every OTHER device kind's parameter rows, by kind."""
    from dbcsr_tpu_torch.acc import params as params_mod

    out: Dict[str, List[Dict]] = {}
    for path in glob.glob(os.path.join(params_mod._params_dir(),
                                       "parameters_*.json")):
        m = _FILE_RE.match(os.path.basename(path))
        if m is None or m.group(1) == exclude_kind:
            continue
        try:
            with open(path) as fh:
                rows = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(rows, list):
            out[m.group(1)] = rows
    return out


def _peak_ratio(target_kind: str, donor_kind: str, dtype) -> float:
    """target peak / donor peak for this dtype — the transfer scale.
    1.0 when either peak is unknown (scaling must never invent a
    regression out of a missing peak table)."""
    try:
        from dbcsr_tpu_torch.obs import costmodel

        # the table's kinds spell spaces as "_" (`acc.params.device_kind`)
        t = costmodel.peak_gflops(target_kind.replace("_", " "), str(dtype))
        d = costmodel.peak_gflops(donor_kind.replace("_", " "), str(dtype))
        if t > 0 and d > 0:
            return float(t) / float(d)
    except Exception:
        pass
    return 1.0


def transfer_predict(m: int, n: int, k: int, dtype,
                     stack_size: Optional[int] = None,
                     kind: Optional[str] = None) -> Optional[Dict]:
    """Nearest donor row from any OTHER device kind's table, GFLOP/s
    scaled by the kinds' peak ratio.  Returns a copy tagged
    ``transfer_from``/``gflops_donor`` (or None when no foreign table
    holds a near-enough same-dtype row)."""
    from dbcsr_tpu_torch.acc import params as params_mod
    from dbcsr_tpu_torch.core.kinds import name_of

    kind = kind or params_mod.device_kind()
    want_dtype = name_of(dtype)
    target = math.log(float(m) * n * k)
    max_d = math.log(_MAX_FLOP_RATIO)
    best, best_key = None, None
    for donor_kind, rows in sorted(_kind_tables(kind).items()):
        for e in rows:
            try:
                if e["dtype"] != want_dtype or not e.get("gflops"):
                    continue
                d = abs(math.log(float(e["m"]) * e["n"] * e["k"]) - target)
            except (KeyError, TypeError, ValueError):
                continue
            if d > max_d:
                continue
            if stack_size is None:
                ds = -float(e.get("stack_size", 0))
            else:
                ds = abs(math.log(max(float(e.get("stack_size", 1)), 1.0))
                         - math.log(max(float(stack_size), 1.0)))
            key = (d, ds)
            if best_key is None or key < best_key:
                best, best_key = (donor_kind, e), key
    if best is None:
        return None
    donor_kind, e = best
    ratio = _peak_ratio(kind, donor_kind, want_dtype)
    out = dict(e)
    out["transfer_from"] = donor_kind
    out["gflops_donor"] = e["gflops"]
    out["gflops"] = round(float(e["gflops"]) * ratio, 3)
    out["peak_ratio"] = round(ratio, 4)
    return out


def format_prior(bm: int, bn: int, bk: int, dtype,
                 kind: Optional[str] = None) -> Optional[Dict]:
    """Nearest SAME-device-kind tuned row carrying learned storage-
    format columns — the format planner's donor fallback when the
    exact block cell was never format-trialed.  Same-dtype rows only,
    within the `_MAX_FLOP_RATIO` shape window; returns a copy tagged
    ``format_from`` (the donor's (m, n, k)) or None.  Cross-device
    format transfer is deliberately NOT offered: a crossover is a
    property of one chip's dense/stack balance, not of the shape."""
    from dbcsr_tpu_torch.acc import params as params_mod
    from dbcsr_tpu_torch.core.kinds import name_of

    kind = kind or params_mod.device_kind()
    want_dtype = name_of(dtype)
    target = math.log(max(float(bm) * bn * bk, 1.0))
    max_d = math.log(_MAX_FLOP_RATIO)
    best, best_d = None, None
    try:
        rows = params_mod._load(kind).values()
    except Exception:
        return None
    for e in rows:
        try:
            if e.get("dtype") != want_dtype or not e.get("format"):
                continue
            d = abs(math.log(max(float(e["m"]) * e["n"] * e["k"], 1.0))
                    - target)
        except (KeyError, TypeError, ValueError):
            continue
        if d > max_d:
            continue
        if best_d is None or d < best_d:
            best, best_d = e, d
    if best is None:
        return None
    out = dict(best)
    out["format_from"] = [int(best["m"]), int(best["n"]), int(best["k"])]
    return out


# ------------------------------------------------------------- learned

def _features(m: int, n: int, k: int, dtype, stack_size: int) -> list:
    from dbcsr_tpu_torch.core.kinds import dtype_of

    isz = float(dtype_of(dtype).itemsize)
    flops = 2.0 * m * n * k
    byts = isz * (m * k + k * n + 2.0 * m * n)
    return [1.0,
            math.log(flops),
            math.log(max(float(stack_size), 1.0)),
            flops / byts,          # per-entry arithmetic intensity
            isz]


class TrialRegressor:
    """Per-driver ridge regression over the feature vector above,
    predicting log-GFLOP/s.  `fit` solves the normal equations in
    closed form (numpy lstsq with a small L2 term); `suggest` returns
    the best-estimated driver entry for an untuned cell."""

    def __init__(self, l2: float = 1e-3):
        self.l2 = l2
        self.weights: Dict[str, list] = {}
        self.n_rows = 0

    def fit(self, rows: List[Dict]) -> int:
        """Train on accumulated evidence rows (params-table schema:
        m/n/k/dtype/stack_size/driver/gflops).  Returns rows used."""
        import numpy as np

        by_driver: Dict[str, list] = {}
        for e in rows:
            try:
                if not e.get("driver") or not e.get("gflops") \
                        or float(e["gflops"]) <= 0:
                    continue
                x = _features(int(e["m"]), int(e["n"]), int(e["k"]),
                              e.get("dtype", "float64"),
                              int(e.get("stack_size", 0)) or 1)
                y = math.log(float(e["gflops"]))
            except (KeyError, TypeError, ValueError):
                continue
            by_driver.setdefault(str(e["driver"]), []).append((x, y))
        self.weights = {}
        self.n_rows = 0
        for driver, xy in by_driver.items():
            if len(xy) < 2:
                continue  # one point cannot constrain a slope
            X = np.asarray([x for x, _ in xy], dtype=np.float64)
            y = np.asarray([v for _, v in xy], dtype=np.float64)
            A = X.T @ X + self.l2 * np.eye(X.shape[1])
            b = X.T @ y
            try:
                w = np.linalg.solve(A, b)
            except np.linalg.LinAlgError:
                continue
            self.weights[driver] = [float(v) for v in w]
            self.n_rows += len(xy)
        return self.n_rows

    def predict_gflops(self, m: int, n: int, k: int, dtype,
                       stack_size: int) -> Dict[str, float]:
        """{driver: estimated GFLOP/s} for every fitted driver."""
        x = _features(m, n, k, dtype, stack_size)
        out = {}
        for driver, w in self.weights.items():
            out[driver] = math.exp(sum(wi * xi for wi, xi in zip(w, x)))
        return out

    def suggest(self, m: int, n: int, k: int, dtype,
                stack_size: int) -> Optional[Dict]:
        """The best-estimated driver as a prediction-tagged entry."""
        from dbcsr_tpu_torch.core.kinds import name_of

        est = self.predict_gflops(m, n, k, dtype, stack_size)
        if not est:
            return None
        driver = max(est, key=est.get)
        return {"m": m, "n": n, "k": k,
                "dtype": name_of(dtype),
                "stack_size": int(stack_size), "driver": driver,
                "grouping": None,
                "gflops": round(est[driver], 3),
                "predicted": "learned"}


def training_rows(kind: Optional[str] = None) -> List[Dict]:
    """Every evidence row the regressor may train on: the device
    kind's params table plus the promotion ledger's per-trial
    candidate lists (losing candidates are evidence too — that is the
    point of keeping them)."""
    from dbcsr_tpu_torch.acc import params as params_mod
    from dbcsr_tpu_torch.tune import store

    kind = kind or params_mod.device_kind()
    rows = [dict(e) for e in params_mod._load(kind).values()]
    for rec in store.load_ledger(kind):
        trial = rec.get("trial") or {}
        base = {f: (rec.get("entry") or {}).get(f)
                for f in ("m", "n", "k", "dtype")}
        tstack = trial.get("stack_size")
        for cand in trial.get("candidates", []):
            row = dict(base, **cand)
            row.setdefault("stack_size", tstack or 0)
            rows.append(row)
    return rows


def lookup_extended(m: int, n: int, k: int, dtype,
                    stack_size: Optional[int] = None,
                    kind: Optional[str] = None,
                    regressor: Optional[TrialRegressor] = None
                    ) -> Optional[Dict]:
    """The full evidence ladder for one cell: real tuned evidence
    (`params.predict`) > cross-kind transfer > learned regressor.
    Lower rungs NEVER override a higher one — prediction quality
    cannot outrank measurement."""
    from dbcsr_tpu_torch.acc import params as params_mod

    real = params_mod.predict(m, n, k, dtype, stack_size=stack_size)
    if real is not None:
        return real
    xfer = transfer_predict(m, n, k, dtype, stack_size=stack_size,
                            kind=kind)
    if xfer is not None:
        return xfer
    reg = regressor
    if reg is None:
        reg = TrialRegressor()
        reg.fit(training_rows(kind))
    return reg.suggest(m, n, k, dtype, stack_size or 0)
