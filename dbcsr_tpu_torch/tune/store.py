"""Versioned promotion store over `acc.params`.

Counterpart of `dbcsr_tpu/tune/store.py`.  The params table stays the
one table dispatch reads; this module owns the online tuner's writes:

* `promote()` writes the winning row through `params.save_entry` (which
  bumps the table's generation, so every plan cached against the old
  generation misses: `mm.multiply`'s plan-cache key and the format
  planner's both hold it) and appends a provenance record to the device
  kind's ledger ``promotions_<kind>.json`` beside the table (atomic
  replace): the trial, the row it displaced, the live roofline fraction
  at promotion and a monotone generation.
* `check_regressions()` is the demotion judge: a promoted row whose
  driver's live roofline fraction (`obs.timeseries`, device seconds
  only) fell below ``DBCSR_TPU_TORCH_TUNE_DEMOTE_RATIO`` (0.5) of its
  at-promotion value, over post-promotion samples, is demoted: removed,
  the displaced row restored, a ``demote`` record appended.
* `peer_sync()` adopts same-device-kind peers' live promotions
  (``DBCSR_TPU_TORCH_FLEET_PEERS``, ``GET /tune/promotions?kind=``),
  bounded by ``DBCSR_TPU_TORCH_FLEET_CACHE_TIMEOUT_S`` per peer with a
  cool-off of ``DBCSR_TPU_TORCH_FLEET_PEER_COOLOFF_S`` after an error;
  `export_promotions()` is the payload such a route serves.

Every write lands in ``DBCSR_TPU_TORCH_PARAMS_DIR`` (`acc.params`);
the committed table is written only when that directory is the
package's own.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from dbcsr_tpu_torch.acc import params as params_mod
from dbcsr_tpu_torch.tune._env import env_float as _env_float

_lock = threading.Lock()


def generation() -> int:
    """The params-table generation plan caches key on (delegates to
    `acc.params.generation`)."""
    return params_mod.generation()


def ledger_path(kind: Optional[str] = None) -> str:
    kind = kind or params_mod.device_kind()
    return os.path.join(params_mod._params_dir(),
                        f"promotions_{kind}.json")


def load_ledger(kind: Optional[str] = None) -> List[Dict]:
    """All promotion/demotion records, oldest first (empty when the
    tuner never promoted on this device kind)."""
    try:
        with open(ledger_path(kind)) as fh:
            recs = json.load(fh)
        return recs if isinstance(recs, list) else []
    except (OSError, ValueError):
        return []


def _write_ledger(recs: List[Dict], kind: Optional[str]) -> None:
    """Atomic replace: a reader (or a crash) never sees a torn ledger."""
    path = ledger_path(kind)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(recs, fh, indent=1)
    os.replace(tmp, path)


def _key_of(row: Dict) -> list:
    return [row["m"], row["n"], row["k"], str(row["dtype"]),
            int(row.get("stack_size", 0))]


def _lookup_exact(m, n, k, dtype, stack_size, kind) -> Optional[Dict]:
    """The CURRENT params row at exactly this key (None when absent) —
    the incumbent a promotion displaces and a demotion restores."""
    from dbcsr_tpu_torch.core.kinds import name_of

    table = params_mod._load(kind)
    return table.get(params_mod._key(m, n, k, name_of(dtype), stack_size))


def _live_roofline(driver: str) -> Optional[float]:
    """The driver's latest live roofline fraction from the telemetry
    store (None when the store is off or holds no such series)."""
    try:
        from dbcsr_tpu_torch.obs import timeseries as ts

        rows = ts.query("dbcsr_tpu_roofline_fraction",
                        labels={"driver": driver}, agg="last")
        vals = [r["value"] for r in rows if r.get("value") is not None]
        return float(vals[-1]) if vals else None
    except Exception:
        return None


def _observe(kind_of_event: str, args: Dict, counter: str,
             **counter_labels) -> None:
    """One promotion/demotion emission: counter + correlated bus event
    + a forced next telemetry sample (the judge must see the new row's
    cells soon)."""
    try:
        from dbcsr_tpu_torch.obs import events as _events
        from dbcsr_tpu_torch.obs import metrics as _metrics

        _metrics.counter(
            counter,
            f"online-tuner {kind_of_event.split('_', 1)[1]}s by the "
            "promotion store (dbcsr_tpu_torch.tune.store)",
        ).inc(**counter_labels)
        _events.publish(kind_of_event, args, flight=True)
        from dbcsr_tpu_torch.obs import timeseries as _ts

        _ts.request_sample(kind_of_event)
    except Exception:
        pass  # observability must never fail a promotion


def promote(entry: Dict, trial: Optional[Dict] = None,
            stack_size: Optional[int] = None,
            kind: Optional[str] = None) -> Dict:
    """Atomically promote one trial winner into the live params table.

    ``entry`` is the winning candidate row (driver/grouping/precision/
    gflops + m, n, k, dtype, stack_size, env as `acc.tune` stamps
    them).  ``stack_size`` re-keys the promotion at the MINED cell's
    production stack size (the trial may have timed a budget-clamped
    smaller stack; the row must replace the incumbent serving the live
    traffic), with the trial's own size kept in provenance.  Returns
    the ledger record."""
    from dbcsr_tpu_torch.core.kinds import name_of

    kind = kind or params_mod.device_kind()
    row = dict(entry)
    row["dtype"] = name_of(row["dtype"])
    trial_stack = int(row.get("stack_size", 0))
    if stack_size is not None and int(stack_size) != trial_stack:
        row["trial_stack_size"] = trial_stack
        row["stack_size"] = int(stack_size)
    row["tuned_by"] = "dbcsr_tpu_torch.tune"
    with _lock:
        prev = _lookup_exact(row["m"], row["n"], row["k"], row["dtype"],
                             row.get("stack_size", 0), kind)
        recs = load_ledger(kind)
        gen = (max((r.get("generation", 0) for r in recs), default=0)
               + 1)
        row["promoted_gen"] = gen
        rec = {
            "action": "promote",
            "generation": gen,
            "key": _key_of(row),
            "entry": row,
            "prev_row": dict(prev) if prev else None,
            "measure_env": row.get("env"),
            "trial": dict(trial or {}),
            "roofline_at_promotion": _live_roofline(row.get("driver", "")),
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
            # unix time: the regression judge only counts samples taken
            # AFTER this instant (points from the displaced row's
            # regime must not condemn the fresh promotion)
            "t_unix": time.time(),
        }
        recs.append(rec)
        _write_ledger(recs, kind)
        # save_entry bumps the params generation under the table lock:
        # every plan cached against the old generation is stale the
        # moment this returns
        params_mod.save_entry(row, kind=kind)
    _observe("tune_promotion",
             {"mnk": f"{row['m']}x{row['n']}x{row['k']}",
              "dtype": row["dtype"], "driver": row.get("driver"),
              "gflops": row.get("gflops"), "generation": gen,
              "displaced": (prev or {}).get("driver")},
             "dbcsr_tpu_tune_promotions_total",
             driver=str(row.get("driver")))
    return rec


def demote(m: int, n: int, k: int, dtype, stack_size: int,
           reason: str = "regression", kind: Optional[str] = None) -> bool:
    """Demote a promoted row: remove it from the params table, restore
    the row it displaced (when one existed), and append a ``demote``
    ledger record.  Both table writes bump the params generation, so
    plans built against the regressed row retire immediately.  Returns
    False when no live promotion exists at this key."""
    from dbcsr_tpu_torch.core.kinds import name_of

    kind = kind or params_mod.device_kind()
    dtype = name_of(dtype)
    key = [m, n, k, dtype, int(stack_size)]
    with _lock:
        recs = load_ledger(kind)
        live = _fold_live(recs).get(tuple(key))
        if live is None:
            return False
        params_mod.delete_entry(m, n, k, dtype, stack_size, kind=kind)
        prev = live.get("prev_row")
        if prev:
            params_mod.save_entry(dict(prev), kind=kind)
        else:
            # delete_entry only bumps on a real removal; a ledger whose
            # row was already hand-removed must still retire plans
            params_mod.invalidate()
        gen = max((r.get("generation", 0) for r in recs), default=0) + 1
        recs.append({
            "action": "demote",
            "generation": gen,
            "key": key,
            "reason": reason,
            "demoted_entry": live.get("entry"),
            "restored": bool(prev),
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
        })
        _write_ledger(recs, kind)
    _observe("tune_demotion",
             {"mnk": f"{m}x{n}x{k}", "dtype": dtype, "reason": reason,
              "generation": gen,
              "driver": (live.get("entry") or {}).get("driver")},
             "dbcsr_tpu_tune_demotions_total", reason=reason)
    return True


def _fold_live(recs: List[Dict]) -> Dict[tuple, Dict]:
    """key-tuple -> latest promotion record still live (not superseded
    by a later demote of the same key)."""
    live: Dict[tuple, Dict] = {}
    for r in recs:
        key = tuple(r.get("key", ()))
        if r.get("action") == "promote":
            live[key] = r
        elif r.get("action") == "demote":
            live.pop(key, None)
    return live


def live_promotions(kind: Optional[str] = None) -> List[Dict]:
    """Promotion records currently in force (ledger folded)."""
    return sorted(_fold_live(load_ledger(kind)).values(),
                  key=lambda r: r.get("generation", 0))


# ------------------------------------------------- fleet-shared tier
#
# Same-fleet siblings answer bounded HTTP GETs: a dead peer costs one
# timeout then cools off, a structured miss (404) never cools anything.
# A worker that tuned a cell serves its live ledger rows over
# ``GET /tune/promotions?kind=…`` (the route comes with the port's
# obs/server.py), and same-device-kind peers adopt them without
# re-trialing: the peer's trial evidence is the evidence.

_peer_down: Dict[str, float] = {}


def _peers() -> List[str]:
    raw = os.environ.get("DBCSR_TPU_TORCH_FLEET_PEERS", "")
    return [p.strip().rstrip("/") for p in raw.split(",") if p.strip()]


def _count_fleet(event: str) -> None:
    try:
        from dbcsr_tpu_torch.obs import metrics as _metrics

        _metrics.counter(
            "dbcsr_tpu_tune_fleet_total",
            "fleet-shared tuning-promotion sync outcomes "
            "(dbcsr_tpu_torch.tune.store.peer_sync)",
        ).inc(event=event)
    except Exception:
        pass


def export_promotions(kind: Optional[str] = None) -> Dict:
    """The wire form of this worker's live promotion rows for
    same-device-kind peers (the ``/tune/promotions`` route's payload).
    ORIGIN rows only: a row this worker itself adopted from a peer
    (``adopted_from``) never re-exports, so a promotion cannot echo
    around the fleet forever."""
    kind = kind or params_mod.device_kind()
    rows = []
    for rec in live_promotions(kind):
        entry = rec.get("entry") or {}
        if entry.get("adopted_from"):
            continue
        rows.append({"key": rec.get("key"), "entry": entry,
                     "generation": rec.get("generation"),
                     "t_unix": rec.get("t_unix")})
    return {"kind": kind, "rows": rows}


def peer_sync(kind: Optional[str] = None, peers=None) -> List[list]:
    """Adopt sibling workers' promoted params rows (fleet-shared
    tuning): for each reachable peer, fetch its live promotions and
    promote locally — through `promote`, so the adoption lands in the
    ledger, bumps the params generation (retiring cached plans), and
    stays demotable by the local regression judge.  A row is adopted
    only when the peer reports the SAME device kind (another chip's
    crossover does not transfer) and local evidence is not already at
    least as good.  Bounded: one ``DBCSR_TPU_TORCH_FLEET_CACHE_TIMEOUT_S``
    timeout per peer, errors cool the peer off for
    ``DBCSR_TPU_TORCH_FLEET_PEER_COOLOFF_S`` (a 404/miss never cools).
    Returns the adopted keys."""
    import json as _json
    import urllib.error as _uerr
    import urllib.request as _rq

    kind = kind or params_mod.device_kind()
    peers = _peers() if peers is None else peers
    if not peers:
        return []
    timeout = _env_float("DBCSR_TPU_TORCH_FLEET_CACHE_TIMEOUT_S", 0.3)
    cooloff = _env_float("DBCSR_TPU_TORCH_FLEET_PEER_COOLOFF_S", 30.0)
    adopted: List[list] = []
    now = time.monotonic()
    for peer in peers:
        with _lock:
            if _peer_down.get(peer, 0.0) > now:
                continue
        try:
            with _rq.urlopen(f"{peer}/tune/promotions?kind={kind}",
                             timeout=timeout) as resp:
                payload = _json.loads(resp.read().decode())
        except _uerr.HTTPError as exc:
            if exc.code == 404:
                # a healthy peer without the route/ledger is a miss,
                # never a cool-off (the serve cache tier's lesson)
                _count_fleet("peer_miss")
                continue
            with _lock:
                _peer_down[peer] = time.monotonic() + cooloff
            _count_fleet("peer_error")
            continue
        except Exception:
            with _lock:
                _peer_down[peer] = time.monotonic() + cooloff
            _count_fleet("peer_error")
            continue
        if str(payload.get("kind")) != kind:
            _count_fleet("kind_mismatch")
            continue
        for rec in payload.get("rows") or []:
            entry = rec.get("entry") or {}
            if not entry or entry.get("adopted_from"):
                continue
            try:
                m = int(entry["m"])
                n = int(entry["n"])
                k = int(entry["k"])
                dtype = str(entry["dtype"])
                s = int(entry.get("stack_size", 0))
            except (KeyError, TypeError, ValueError):
                continue
            incumbent = _lookup_exact(m, n, k, dtype, s, kind)
            if incumbent and incumbent.get("tuned_by") and \
                    float(incumbent.get("gflops") or 0.0) >= \
                    float(entry.get("gflops") or 0.0) and \
                    incumbent.get("format") == entry.get("format"):
                continue  # local evidence already as good: no churn
            promote(dict(entry, adopted_from=peer),
                    trial={"adopted_from": peer,
                           "peer_generation": rec.get("generation")},
                    kind=kind)
            adopted.append([m, n, k, dtype, s])
            _count_fleet("adopted")
    return adopted


def check_regressions(kind: Optional[str] = None,
                      ratio: Optional[float] = None,
                      min_samples: int = 4,
                      query=None) -> List[Dict]:
    """The demotion judge: for every live promotion whose record
    carries an at-promotion roofline fraction, read the driver's
    recent live fraction from the telemetry store and demote the row
    when the recent median fell below ``ratio`` (default
    ``DBCSR_TPU_TORCH_TUNE_DEMOTE_RATIO`` = 0.5) of the at-promotion value.
    ``query`` is injectable (tests); needs at least ``min_samples``
    post-promotion points before judging.  Returns the demoted ledger
    keys."""
    if ratio is None:
        ratio = _env_float("DBCSR_TPU_TORCH_TUNE_DEMOTE_RATIO", 0.5)
    if query is None:
        try:
            from dbcsr_tpu_torch.obs import timeseries as ts

            query = ts.query
        except Exception:
            return []
    from dbcsr_tpu_torch.obs.windows import median

    demoted = []
    for rec in live_promotions(kind):
        frac0 = rec.get("roofline_at_promotion")
        entry = rec.get("entry") or {}
        # a format-axis promotion executes under the canvas driver it
        # promoted (dense/composite), not the row's kernel driver — the
        # judge must watch the roofline cell that row actually produces
        driver = entry.get("format_driver") or entry.get("driver")
        if not frac0 or not driver:
            continue
        try:
            rows = query("dbcsr_tpu_roofline_fraction",
                         labels={"driver": driver})
        except Exception:
            continue
        # POST-promotion samples only: trailing points from the
        # displaced row's regime would condemn a promotion that never
        # served a single request
        t0 = float(rec.get("t_unix", 0.0))
        pts = [v for r in rows for t, v in r.get("points", [])
               if t >= t0]
        pts = pts[-max(min_samples, 1):]
        if len(pts) < min_samples:
            continue
        recent = median(pts)
        if recent < ratio * float(frac0):
            m, n, k, dtype, s = rec["key"]
            if demote(m, n, k, dtype, s,
                      reason=f"regression:{recent:.4f}<"
                             f"{ratio:.2f}*{float(frac0):.4f}",
                      kind=kind):
                demoted.append(rec["key"])
    return demoted
