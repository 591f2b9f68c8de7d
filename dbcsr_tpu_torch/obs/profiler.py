"""Profile epochs: per-(driver, cell, phase) timing histograms, sealed
into epochs tagged by the tuned table's generation.

Counterpart of `dbcsr_tpu/obs/profiler.py`.  Every committed flight
record (`obs/flight.py`: the product's host milliseconds per phase, its
drivers, its m, n, k) folds into histograms keyed by

    (primary driver, mnk cell, phase)

where the cell is the power-of-two bucket of the product's shape.
Every 64 multiplies the accumulation is sealed into an
epoch stamped with its time range and `acc.params.generation()`, kept
in a ring of 32.  `diff` compares two snapshots (or merged ranges,
`merge`) per key and per phase and names the worst regression;
`diff_around` splits the epochs at a time (`obs.rca`'s report reads
it).  `set_enabled(False)` stops the folding (the JAX package's
``DBCSR_TPU_PROFILE=0``; `reset` turns it back on); `epoch_n` is the
epoch length.  The JAX package's JSONL sink of sealed epochs has no
counterpart.

Stdlib-only: `obs.flight.commit` calls `observe`.
"""

from __future__ import annotations

import collections
import threading
import time

_lock = threading.Lock()

_EPOCH_RING_N = 32      # sealed epochs kept in memory
_HIST_BUCKETS = 18      # log2-ms buckets: <1ms .. >64s


# multiplies per sealed epoch
_epoch_n = 64
_enabled = True


def epoch_n() -> int:
    return _epoch_n


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Turn the folding of flight records on or off."""
    global _enabled
    _enabled = bool(on)


# ----------------------------------------------------------- current fold

def _new_current() -> dict:
    return {
        "t0": None, "t1": None, "n": 0,
        # key "driver|cell|phase" -> [count, sum_ms, max_ms, hist...]
        "cells": {},
        # key "driver|cell" -> [n, occ_sum] (occupancy population)
        "occ": {},
    }


_current = _new_current()
_epochs: collections.deque = collections.deque(maxlen=_EPOCH_RING_N)
_epoch_seq = 0
# multiplies and their milliseconds since the last reset, over all epochs
_totals = {"n": 0, "ms": 0.0}


def _pow2_cell(mnk) -> str:
    try:
        return "x".join(
            str(1 << max(0, int(d) - 1).bit_length()) for d in mnk)
    except (TypeError, ValueError):
        return "?"


def _hist_idx(ms: float) -> int:
    b = 0
    v = ms
    while v >= 1.0 and b < _HIST_BUCKETS - 1:
        v /= 2.0
        b += 1
    return b


def _primary_driver(rec: dict) -> str:
    drivers = rec.get("drivers") or {}
    if drivers:
        return max(drivers,
                   key=lambda d: drivers[d].get("entries", 0) or 0)
    return str(rec.get("algorithm") or "none")


def observe(rec: dict) -> None:
    """Fold one committed flight record into the current epoch (called
    by `obs.flight.commit`)."""
    global _current
    if not rec or not _enabled:
        return
    phases = rec.get("phases_ms")
    if not phases:
        return
    driver = _primary_driver(rec)
    cell = _pow2_cell(rec.get("mnk") or ())
    now = time.time()
    with _lock:
        cur = _current
        if cur["t0"] is None:
            cur["t0"] = now
        cur["t1"] = now
        cur["n"] += 1
        _totals["n"] += 1
        try:
            _totals["ms"] += float(rec.get("dur_ms") or 0.0)
        except (TypeError, ValueError):
            pass
        for phase, ms in phases.items():
            try:
                ms = float(ms)
            except (TypeError, ValueError):
                continue
            key = f"{driver}|{cell}|{phase}"
            row = cur["cells"].get(key)
            if row is None:
                row = cur["cells"][key] = \
                    [0, 0.0, 0.0] + [0] * _HIST_BUCKETS
            row[0] += 1
            row[1] += ms
            if ms > row[2]:
                row[2] = ms
            row[3 + _hist_idx(ms)] += 1
        occ = rec.get("occ_c")
        if occ is None:
            occ = rec.get("occ_a")
        if occ is not None:
            okey = f"{driver}|{cell}"
            orow = cur["occ"].get(okey)
            if orow is None:
                orow = cur["occ"][okey] = [0, 0.0]
            orow[0] += 1
            orow[1] += float(occ)
        full = cur["n"] >= _epoch_n
    if full:
        seal()


def _generation() -> int:
    from dbcsr_tpu_torch.acc import params as _params

    return int(_params.generation())


def seal() -> dict | None:
    """Seal the current accumulation into an epoch snapshot: ring it and
    start a fresh epoch.  Returns the sealed epoch (None when nothing
    accumulated)."""
    global _current, _epoch_seq
    with _lock:
        if _current["n"] == 0:
            return None
        _epoch_seq += 1
        epoch = {
            "epoch": _epoch_seq,
            "t0": _current["t0"], "t1": _current["t1"],
            "n": _current["n"],
            "generation": _generation(),
            "cells": _current["cells"],
            "occ": _current["occ"],
        }
        _epochs.append(epoch)
        _current = _new_current()
    return epoch


# --------------------------------------------------------------- reads

def totals() -> dict:
    """{n, ms}: the multiplies folded since the last reset and their
    milliseconds, over all epochs."""
    with _lock:
        return dict(_totals)


def epochs(limit: int | None = None) -> list:
    """Sealed epoch snapshots, oldest first."""
    with _lock:
        out = list(_epochs)
    if limit is not None and limit >= 0:
        out = out[-limit:]
    return out


def current() -> dict:
    """The live (unsealed) accumulation, as a snapshot-shaped dict."""
    with _lock:
        return {
            "epoch": None,
            "t0": _current["t0"], "t1": _current["t1"],
            "n": _current["n"],
            "generation": _generation(),
            "cells": {k: list(v) for k, v in _current["cells"].items()},
            "occ": {k: list(v) for k, v in _current["occ"].items()},
        }


def merge(snaps: list) -> dict:
    """Merge several snapshots into one (window-pair assembly)."""
    out = {"epoch": None, "t0": None, "t1": None, "n": 0,
           "generation": 0, "cells": {}, "occ": {}}
    for s in snaps:
        if not s or not s.get("n"):
            continue
        out["n"] += s["n"]
        out["generation"] = max(out["generation"],
                                s.get("generation") or 0)
        if s.get("t0") is not None and \
                (out["t0"] is None or s["t0"] < out["t0"]):
            out["t0"] = s["t0"]
        if s.get("t1") is not None and \
                (out["t1"] is None or s["t1"] > out["t1"]):
            out["t1"] = s["t1"]
        for key, row in (s.get("cells") or {}).items():
            dst = out["cells"].get(key)
            if dst is None:
                out["cells"][key] = list(row)
                continue
            dst[0] += row[0]
            dst[1] += row[1]
            dst[2] = max(dst[2], row[2])
            for i in range(3, min(len(dst), len(row))):
                dst[i] += row[i]
        for key, row in (s.get("occ") or {}).items():
            dst = out["occ"].get(key)
            if dst is None:
                out["occ"][key] = list(row)
            else:
                dst[0] += row[0]
                dst[1] += row[1]
    return out


def _resolve(ref):
    """A snapshot argument: a dict, an epoch number, ``"current"``, or
    a negative ring index (-1 = most recent sealed)."""
    if isinstance(ref, dict):
        return ref
    if ref == "current":
        return current()
    with _lock:
        eps = list(_epochs)
    if isinstance(ref, int):
        if ref < 0:
            return eps[ref] if eps and -ref <= len(eps) else None
        for e in eps:
            if e["epoch"] == ref:
                return e
    return None


def diff(baseline_a, baseline_b, top: int = 8) -> dict:
    """Differential profile between two snapshots: per-(driver, cell,
    phase) mean-ms deltas sorted by total impact, a per-phase rollup,
    and the single worst key — the regression LOCALIZED to a phase and
    cell population."""
    a = _resolve(baseline_a)
    b = _resolve(baseline_b)
    if not a or not b or not a.get("n") or not b.get("n"):
        return {"ok": False, "reason": "missing snapshot",
                "a": _meta(a), "b": _meta(b), "phases": [],
                "by_phase": {}, "top": None}
    rows = []
    for key in set(a["cells"]) | set(b["cells"]):
        ra = a["cells"].get(key)
        rb = b["cells"].get(key)
        mean_a = (ra[1] / ra[0]) if ra and ra[0] else 0.0
        mean_b = (rb[1] / rb[0]) if rb and rb[0] else 0.0
        delta = mean_b - mean_a
        driver, cell, phase = (key.split("|") + ["?", "?"])[:3]
        rows.append({
            "driver": driver, "cell": cell, "phase": phase,
            "mean_ms_a": mean_a, "mean_ms_b": mean_b,
            "delta_ms": delta,
            "ratio": (mean_b / mean_a) if mean_a > 0 else None,
            "count_a": ra[0] if ra else 0,
            "count_b": rb[0] if rb else 0,
        })
    rows.sort(key=lambda r: abs(r["delta_ms"]), reverse=True)
    by_phase: dict = {}
    for r in rows:
        by_phase[r["phase"]] = by_phase.get(r["phase"], 0.0) \
            + r["delta_ms"]
    regressed = [r for r in rows if r["delta_ms"] > 0]
    return {
        "ok": True,
        "a": _meta(a), "b": _meta(b),
        "phases": rows[:max(1, int(top))],
        "by_phase": by_phase,
        "top": regressed[0] if regressed else None,
    }


def _meta(snap) -> dict | None:
    if not snap:
        return None
    return {"epoch": snap.get("epoch"), "t0": snap.get("t0"),
            "t1": snap.get("t1"), "n": snap.get("n", 0),
            "generation": snap.get("generation", 0)}


def diff_around(t: float, top: int = 8) -> dict:
    """The window-pair diff for a change-point at time ``t``: epochs
    sealed before the shift vs epochs (plus the live accumulation)
    after it."""
    with _lock:
        eps = list(_epochs)
    before = [e for e in eps if (e.get("t1") or 0) <= t]
    after = [e for e in eps if (e.get("t0") or 0) > t]
    cur = current()
    if cur["n"]:
        after.append(cur)
    if not before and eps:
        # the shift estimate can precede the first seal; fall back to
        # oldest-vs-newest so the diff still localizes the phase
        before = eps[:max(1, len(eps) // 2)]
        after = [e for e in eps[len(before):]] + \
            ([cur] if cur["n"] else [])
    return diff(merge(before), merge(after), top=top)


def reset() -> None:
    """Drop all accumulation and sealed epochs, and fold again."""
    global _current, _epoch_seq, _enabled
    _enabled = True
    with _lock:
        _current = _new_current()
        _epochs.clear()
        _epoch_seq = 0
        _totals["n"] = 0
        _totals["ms"] = 0.0
