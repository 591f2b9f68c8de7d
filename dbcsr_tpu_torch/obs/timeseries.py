"""Telemetry history plane: a sampled, multi-resolution time-series store.

Counterpart of `dbcsr_tpu/obs/timeseries.py`:

* **Sampling**: on a cadence (``DBCSR_TPU_TORCH_TS_INTERVAL_S``,
  default 10 s; ``0`` samples at every product boundary) `sample()`
  scrapes one point per live series: the roofline rollup per driver and
  the flops per (driver, mnk, dtype) cell, breaker states, pool and
  transfer meters, ABFT counters, the precision cells, the incremental
  and plan-cache counters, the tuner's counters, the health status per
  component, the format planner's decisions and regrets, the tenant
  meters, the profile totals, and the SLO burn gauges `obs.slo` derives
  from the store itself.  `maybe_sample()` is the product-boundary hook
  (`events.end_product`); health and SLO rising edges call
  `request_sample()`, which forces the next boundary's sample.
* **Retention**: each series keeps a raw ring
  (``DBCSR_TPU_TORCH_TS_RAW_N`` = 512) and 1-minute and 10-minute
  tiers (``_1M_N`` = 360, ``_10M_N`` = 288 buckets) of
  last/min/max/sum/count; counters merge by ``max``, so a monotone
  counter never decreases across a downsample.
* **Persistence**: ``DBCSR_TPU_TORCH_TS=<base path>`` streams every
  sample as one JSONL line to the process's shard (`obs.shard`; the
  rank's rebind in `parallel.multihost`); ``0`` turns the store off;
  unset keeps the rings in memory only.
* **Query**: `query(metric, labels=, since=, agg=, tier=, path=)` reads
  the live rings or a shard family's replay, which rebuilds the same
  rings and tiers.

Rates are device rates only: ``dbcsr_tpu_roofline_fraction`` and
``dbcsr_tpu_achieved_gflops`` come from the regions timed after a
synchronize (`core.stats._DriverAgg.sync_*`), so a driver whose seconds
are all dispatch seconds (the card without
``DBCSR_TPU_TORCH_SYNC_TIMING=1``) has no rate series: the SLO floor and
the tuner's miner never read a dispatch rate.  The JAX package's
seconds are device seconds by construction (it blocks on the result).

Stdlib at module level (`obs.shard`, `utils.lockcheck`); every engine
layer is reached lazily inside the collectors.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time

from dbcsr_tpu_torch.obs import shard as _shard
from dbcsr_tpu_torch.utils import lockcheck as _lockcheck

GAUGE = "gauge"
COUNTER = "counter"

# downsample tier widths, seconds (raw -> 1-min -> 10-min)
TIERS = (60.0, 600.0)

_lock = _lockcheck.wrap("obs.timeseries", threading.Lock())


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


# "0"/"off" disables the store entirely; a path enables the JSONL
# shard sink; unset/other keeps the in-memory rings on (mirrors
# DBCSR_TPU_TORCH_EVENTS)
_env = os.environ.get("DBCSR_TPU_TORCH_TS", "")
_enabled = _env not in ("0", "off")


# parsed-interval cache keyed by the raw env string: maybe_sample runs
# at every product boundary with the store on by default, so the float
# parse must not repeat per multiply (env re-reads stay, so tests that
# monkeypatch the knob see it immediately)
_iv_cache: list = [None, 10.0]


def _interval_s() -> float:
    raw = os.environ.get("DBCSR_TPU_TORCH_TS_INTERVAL_S")
    if raw != _iv_cache[0]:
        _iv_cache[0] = raw
        try:
            _iv_cache[1] = max(0.0, float(raw)) if raw is not None \
                else 10.0
        except ValueError:
            _iv_cache[1] = 10.0
    return _iv_cache[1]


def _raw_n() -> int:
    return max(8, _env_int("DBCSR_TPU_TORCH_TS_RAW_N", 512))


def _tier_n(width: float) -> int:
    if width == 60.0:
        return max(8, _env_int("DBCSR_TPU_TORCH_TS_1M_N", 360))
    return max(8, _env_int("DBCSR_TPU_TORCH_TS_10M_N", 288))


class _Series:
    """One (metric, labels) series: raw ring + per-tier bucket rings."""

    __slots__ = ("metric", "labels", "kind", "raw", "tiers")

    def __init__(self, metric: str, labels: dict, kind: str):
        self.metric = metric
        self.labels = dict(labels)
        self.kind = kind
        self.raw: collections.deque = collections.deque(maxlen=_raw_n())
        self.tiers = {w: collections.deque(maxlen=_tier_n(w))
                      for w in TIERS}

    def add(self, t: float, v: float) -> None:
        self.raw.append((t, v))
        for width, dq in self.tiers.items():
            b0 = math.floor(t / width) * width
            if dq and dq[-1]["t"] == b0:
                b = dq[-1]
                # counters merge by max: a monotone input can never
                # produce a decreasing downsample, even if a scrape
                # lands out of order inside the bucket
                b["last"] = (max(b["last"], v) if self.kind == COUNTER
                             else v)
                b["min"] = min(b["min"], v)
                b["max"] = max(b["max"], v)
                b["sum"] += v
                b["count"] += 1
            elif dq and dq[-1]["t"] > b0:
                pass  # sample older than the open bucket: raw keeps it
            else:
                dq.append({"t": b0, "last": v, "min": v, "max": v,
                           "sum": v, "count": 1})


def _series_key(metric: str, labels: dict) -> tuple:
    return (metric, tuple(sorted(labels.items())))


def _sanitize(points) -> list:
    """Well-formed ``[metric, labels, float value, kind]`` rows only —
    a registered collector returning one malformed point must never
    abort the sample (or poison the persisted record)."""
    out = []
    for pt in points:
        try:
            metric, labels, value, kind = pt
            # dict() also validates: non-dict labels (None, an int, a
            # string of pairs) must fail HERE, not later in
            # _series_key's labels.items()
            out.append((str(metric), dict(labels or {}), float(value),
                        str(kind)))
        except (TypeError, ValueError):
            continue
    return out


class _Store:
    """Series registry — one lives at module level, `query(path=...)`
    rebuilds throwaway ones from shard replays."""

    def __init__(self):
        self.series: dict = {}
        self.seq = 0

    def ingest(self, t: float, points) -> None:
        for pt in points:
            try:
                metric, labels, value, kind = pt
                labels = dict(labels or {})
                v = float(value)
            except (TypeError, ValueError):
                continue  # ONE malformed point (a broken registered
                #           collector, a corrupt shard row) must not
                #           drop the whole sample / replay
            key = _series_key(metric, labels)
            s = self.series.get(key)
            if s is None:
                s = self.series[key] = _Series(metric, labels, kind)
            s.add(float(t), v)

    def match(self, metric: str | None, labels: dict | None) -> list:
        out = []
        for s in self.series.values():
            if metric is not None and s.metric != metric:
                continue
            if labels and any(s.labels.get(k) != str(v) and
                              s.labels.get(k) != v
                              for k, v in labels.items()):
                continue
            out.append(s)
        return out


_store = _Store()

# cadence + deferred-force state; the generation counter lets sample()
# consume exactly the requests pending when it started (string identity
# would drop a mid-sample request whose interned reason matched)
_last_sample_t = 0.0
_pending_force: str | None = None
_force_gen = 0
_sampling = False

# JSONL shard sink (the trace/events contract — obs.shard)
_sink = None
_sink_base: str | None = None
_sink_path: str | None = None
_sink_pid_final = False

# extra collectors registered by tests / embedding apps
_extra_collectors: list = []


# ------------------------------------------------------------ switches

def enabled() -> bool:
    """True when the store samples; False = every hook is a single
    attribute check (``DBCSR_TPU_TORCH_TS=0``)."""
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def reset() -> None:
    """Drop every series, the cadence state and registered extra
    collectors (tests; paired with `metrics.reset`).  The sink stays
    open — its shard is an append log."""
    global _store, _last_sample_t, _pending_force
    with _lock:
        _store = _Store()
        _last_sample_t = 0.0
        _pending_force = None
        del _extra_collectors[:]


def register_collector(fn) -> None:
    """Add a callable returning an iterable of
    ``(metric, labels_dict, value, kind)`` points, scraped on every
    sample (embedding apps; cleared by `reset`)."""
    _extra_collectors.append(fn)


# ---------------------------------------------------------- collectors

def _collect_engine() -> list:
    """Roofline rollup per driver (device seconds only) and the flops
    per (driver, mnk, dtype) cell: the tuner's evidence."""
    pts: list = []
    try:
        from dbcsr_tpu_torch.core import stats
        from dbcsr_tpu_torch.obs import costmodel
    except Exception:
        return pts
    kind = costmodel.device_kind()
    # snapshot every registry with C-level list()/dict() calls before
    # iterating: a concurrent multiply may insert a key meanwhile
    for driver, agg in list(stats._driver_agg.items()):
        by_dtype = dict(agg.by_dtype)
        if agg.sync_seconds > 0 and agg.sync_flops > 0:
            dtype = max(by_dtype, key=by_dtype.get) \
                if by_dtype else "float64"
            rl = costmodel.roofline(agg.sync_flops, agg.sync_nbytes,
                                    agg.sync_seconds, kind=kind, dtype=dtype)
            pts.append(("dbcsr_tpu_roofline_fraction", {"driver": driver},
                        rl["roofline_fraction"], GAUGE))
            pts.append(("dbcsr_tpu_achieved_gflops", {"driver": driver},
                        rl["achieved_gflops"], GAUGE))
        pts.append(("dbcsr_tpu_dispatch_seconds_total", {"driver": driver},
                    agg.seconds, COUNTER))
        for dtype, fl in by_dtype.items():
            pts.append(("dbcsr_tpu_flops_total",
                        {"driver": driver, "dtype": dtype}, fl, COUNTER))
    for (m, n, k), st in list(stats._by_mnk.items()):
        mnk = f"{m}x{n}x{k}"
        for (driver, dtype), fl in dict(st.by_driver_dtype).items():
            pts.append(("dbcsr_tpu_cell_flops_total",
                        {"mnk": mnk, "driver": driver, "dtype": dtype},
                        fl, COUNTER))
    pts.append(("dbcsr_tpu_multiplies_total", {},
                stats._totals["multiplies"], COUNTER))
    return pts


def _collect_serve() -> list:
    """Serve queue/latency/shed rates of the running engine (a scrape
    never creates one)."""
    import sys

    pts: list = []
    from dbcsr_tpu_torch.obs import metrics
    for name in ("dbcsr_tpu_serve_requests_total",
                 "dbcsr_tpu_serve_shed_total",
                 "dbcsr_tpu_serve_deadline_missed_total"):
        for labels, v in metrics.counter_items(name):
            pts.append((name, labels, v, COUNTER))
    eng_mod = sys.modules.get("dbcsr_tpu_torch.serve.engine")
    eng = eng_mod.current_engine() if eng_mod is not None else None
    if eng is not None:
        pts.append(("dbcsr_tpu_serve_queue_depth", {},
                    eng.queue.depth(), GAUGE))
        for tenant, q in eng.latency_quantiles().items():
            pts.append(("dbcsr_tpu_serve_latency_p50_ms",
                        {"tenant": tenant}, q["p50_ms"], GAUGE))
            pts.append(("dbcsr_tpu_serve_latency_p95_ms",
                        {"tenant": tenant}, q["p95_ms"], GAUGE))
    return pts


def _collect_breakers() -> list:
    import sys

    pts = []
    # fallback/failure counters ride this collector so the change-point
    # detector's fallback_rate series replays from the shard alone
    from dbcsr_tpu_torch.obs import metrics

    for name in ("dbcsr_tpu_driver_fallback_total",
                 "dbcsr_tpu_driver_failures_total"):
        for labels, v in metrics.counter_items(name):
            pts.append((name, labels, v, COUNTER))
    br = sys.modules.get("dbcsr_tpu_torch.resilience.breaker")
    board = getattr(br, "_board", None) if br is not None else None
    if board is None:
        return pts  # never CREATE a board just to sample it
    code = {"closed": 0, "half_open": 1, "open": 2}
    for key, ent in board.snapshot().items():
        driver, _, shape = key.partition("|")
        pts.append(("dbcsr_tpu_breaker_state",
                    {"driver": driver, "shape": shape},
                    code.get(ent["state"], 0), GAUGE))
    return pts


def _collect_pool() -> list:
    pts: list = []
    try:
        from dbcsr_tpu_torch.core import mempool

        p = mempool.pool_stats()
    except Exception:
        return pts
    for k in ("hits", "misses", "returns", "evictions",
              "h2d_bytes", "d2h_bytes"):
        pts.append((f"dbcsr_tpu_pool_{k}_total" if "bytes" not in k
                    else f"dbcsr_tpu_{k}_total", {}, p[k], COUNTER))
    pts.append(("dbcsr_tpu_pool_bytes_held", {}, p["bytes_held"], GAUGE))
    return pts


def _collect_integrity() -> list:
    from dbcsr_tpu_torch.obs import metrics

    pts: list = []
    for name in ("dbcsr_tpu_abft_checks_total",
                 "dbcsr_tpu_abft_mismatches_total",
                 "dbcsr_tpu_abft_recoveries_total",
                 "dbcsr_tpu_chain_rollback_total",
                 "dbcsr_tpu_anomalies_total"):
        for labels, v in metrics.counter_items(name):
            pts.append((name, labels, v, COUNTER))
    return pts


def _collect_health() -> list:
    """Per-component health status as a 0/1/2 gauge series — the
    trend table of how the verdict moved."""
    try:
        from dbcsr_tpu_torch.obs import health
    except Exception:
        return []
    code = {health.OK: 0, health.DEGRADED: 1, health.CRITICAL: 2}
    try:
        v = health.verdict()
    except Exception:
        return []
    pts = [("dbcsr_tpu_health_status", {"component": "overall"},
            code.get(v["status"], 0), GAUGE)]
    for name, comp in v["components"].items():
        pts.append(("dbcsr_tpu_health_status", {"component": name},
                    code.get(comp["status"], 0), GAUGE))
    return pts


def _collect_precision() -> list:
    """Executed-precision plane (acc.precision): per-(m,n,k,dtype)
    adaptive cell state (1 = running demoted, 0 = promoted back to
    native), the cell's last probe residual (demotion headroom), and
    the demoted-launch / promotion counters — a trend reader renders
    these next to the `dbcsr_tpu_cell_flops_total` cells, whose dtype
    label records the EXECUTED compute dtype."""
    import sys

    pts: list = []
    from dbcsr_tpu_torch.obs import metrics

    for name in ("dbcsr_tpu_precision_launches_total",
                 "dbcsr_tpu_precision_promotions_total"):
        for labels, v in metrics.counter_items(name):
            pts.append((name, labels, v, COUNTER))
    prec = sys.modules.get("dbcsr_tpu_torch.acc.precision")
    if prec is None:
        return pts  # planner never imported: nothing ever demoted
    for (m, n, k, dt), info in prec.cells_snapshot().items():
        labels = {"mnk": f"{m}x{n}x{k}", "dtype": dt}
        pts.append(("dbcsr_tpu_precision_cell_demoted", labels,
                    0.0 if info["state"] == "promoted" else 1.0, GAUGE))
        pts.append(("dbcsr_tpu_precision_cell_rel_err", labels,
                    info["last_rel_err"], GAUGE))
    return pts


def _collect_value_reuse() -> list:
    """Value-reuse plane: incremental-multiply outcomes/savings and the
    serve-layer content-addressed product cache (hit rates, pinned
    bytes per tenant) — a trend reader renders these alongside the
    plan-cache and pool series they extend."""
    import sys

    pts: list = []
    from dbcsr_tpu_torch.obs import metrics

    for name in ("dbcsr_tpu_incremental_total",
                 "dbcsr_tpu_incremental_saved_flops_total",
                 "dbcsr_tpu_incremental_saved_bytes_total",
                 "dbcsr_tpu_incremental_degrade_total",
                 "dbcsr_tpu_plan_cache_total",
                 "dbcsr_tpu_product_cache_total",
                 "dbcsr_tpu_product_cache_saved_flops_total"):
        for labels, v in metrics.counter_items(name):
            pts.append((name, labels, v, COUNTER))
    pcm = sys.modules.get("dbcsr_tpu_torch.serve.product_cache")
    if pcm is not None:  # never instantiated by a scrape
        snap = pcm.snapshot()
        pts.append(("dbcsr_tpu_product_cache_bytes", {},
                    snap["bytes"], GAUGE))
        for t, v in snap["bytes_by_tenant"].items():
            pts.append(("dbcsr_tpu_product_cache_bytes", {"tenant": t},
                        v, GAUGE))
    return pts


def _collect_tune() -> list:
    """Online-autotuner plane (dbcsr_tpu_torch.tune): trial/promotion/
    demotion counters, the mined-queue depth and cycle duration, and
    the params-table generation (a counter: every promotion/demotion
    bumps it, so a trend reader can line parameter changes up
    against the roofline cells they were meant to move)."""
    import sys

    pts: list = []
    from dbcsr_tpu_torch.obs import metrics

    for name in ("dbcsr_tpu_tune_trials_total",
                 "dbcsr_tpu_tune_promotions_total",
                 "dbcsr_tpu_tune_demotions_total"):
        for labels, v in metrics.counter_items(name):
            pts.append((name, labels, v, COUNTER))
    svc_mod = sys.modules.get("dbcsr_tpu_torch.tune.service")
    svc = svc_mod.current_service() if svc_mod is not None else None
    if svc is not None:  # never CREATE a service just to sample it
        snap = svc.snapshot()
        pts.append(("dbcsr_tpu_tune_queue_depth", {},
                    snap["queue_depth"], GAUGE))
        pts.append(("dbcsr_tpu_tune_cycle_seconds", {},
                    snap["last_cycle_s"], GAUGE))
    pm = sys.modules.get("dbcsr_tpu_torch.acc.params")
    if pm is not None:
        try:
            pts.append(("dbcsr_tpu_params_generation", {},
                        pm.generation(), COUNTER))
        except Exception:
            pass
    return pts


def _collect_format() -> list:
    """Storage-format planner plane (mm.format_planner): the
    decision counter by (format, reason), the fleet-sync counter, and
    per-format planner REGRET (latest measured/predicted GFLOP/s
    ratio) — the series `tune.miner.mine_format` and a trend reader
    line mis-crossovers up against."""
    import sys

    pts: list = []
    from dbcsr_tpu_torch.obs import metrics

    for name in ("dbcsr_tpu_format_decision_total",
                 "dbcsr_tpu_tune_fleet_total"):
        for labels, v in metrics.counter_items(name):
            pts.append((name, labels, v, COUNTER))
    fp = sys.modules.get("dbcsr_tpu_torch.mm.format_planner")
    if fp is not None:  # an un-imported planner has no regrets
        try:
            # regret_gauges() yields (labels_dict, ratio) rows
            for labels, ratio in fp.regret_gauges():
                pts.append(("dbcsr_tpu_format_regret", dict(labels),
                            ratio, GAUGE))
        except Exception:
            pass
    return pts


def _collect_attribution() -> list:
    """Tenant cost-attribution plane (obs.attribution): the per-tenant
    device-seconds/flops/bytes/saved meters, sampled into shards so
    tenant usage history replays from the shard."""
    pts: list = []
    from dbcsr_tpu_torch.obs import metrics

    for name in ("dbcsr_tpu_tenant_device_seconds_total",
                 "dbcsr_tpu_tenant_flops_total",
                 "dbcsr_tpu_tenant_bytes_moved_total",
                 "dbcsr_tpu_tenant_saved_flops_total"):
        for labels, v in metrics.counter_items(name):
            pts.append((name, labels, v, COUNTER))
    return pts


def _collect_workload() -> list:
    """Workload observability plane: trace records captured by the serve recorder, replayed-request
    meters, and whether the recorder sink is live — so a capacity
    certification run leaves its own telemetry trail."""
    import sys

    pts: list = []
    from dbcsr_tpu_torch.obs import metrics

    for name in ("dbcsr_tpu_workload_records_total",
                 "dbcsr_tpu_replay_requests_total"):
        for labels, v in metrics.counter_items(name):
            pts.append((name, labels, v, COUNTER))
    wl = sys.modules.get("dbcsr_tpu_torch.serve.workload")
    if wl is not None:  # never import the recorder just to sample it
        pts.append(("dbcsr_tpu_workload_sink_active", {},
                    1.0 if wl.sink_active() else 0.0, GAUGE))
    return pts


def _collect_profiler() -> list:
    """Continuous-profile plane (obs.profiler): the monotonic
    multiply-wall counter pair the latency change-point series derives
    from (dispatch_seconds only moves when a plan is BUILT, so cached
    steady-state multiplies would otherwise read as zero latency) plus
    the sealed-epoch cursor."""
    import sys

    pts: list = []
    prof = sys.modules.get("dbcsr_tpu_torch.obs.profiler")
    if prof is None:  # never import the profiler just to sample it
        return pts
    tot = prof.totals()
    pts.append(("dbcsr_tpu_multiply_seconds_total", {},
                tot["ms"] / 1e3, COUNTER))
    pts.append(("dbcsr_tpu_profiled_multiplies_total", {},
                float(tot["n"]), COUNTER))
    return pts


_COLLECTORS = (_collect_engine, _collect_serve, _collect_breakers,
               _collect_pool, _collect_integrity, _collect_precision,
               _collect_value_reuse, _collect_tune, _collect_health,
               _collect_format, _collect_attribution, _collect_workload,
               _collect_profiler)


# ------------------------------------------------------------ sampling

def request_sample(reason: str = "forced") -> None:
    """Force the NEXT `maybe_sample` boundary to sample regardless of
    cadence (health-transition / SLO-burn rising edges call this —
    deferred, so a detector firing under its own lock never re-enters
    the collectors)."""
    global _pending_force, _force_gen
    if not _enabled:
        return
    with _lock:
        # under the lock: sample()'s generation-compare must never
        # observe the new reason with the old generation (it would
        # clear a request raised mid-sample)
        _pending_force = reason
        _force_gen += 1


def maybe_sample(now: float | None = None) -> dict | None:
    """The hot-path hook: sample when the cadence elapsed or a forced
    sample is pending.  One attribute check when the store is off."""
    if not _enabled:
        return None
    now = time.time() if now is None else now
    reason = _pending_force
    if reason is None:
        iv = _interval_s()
        if _last_sample_t and now - _last_sample_t < iv:
            return None
        reason = "interval"
    return sample(now=now, reason=reason)


def on_product() -> None:
    """Product-boundary hook (`events.end_product`): its own errors are
    bookkeeping and never fail a multiply; a device's error is raised."""
    if not _enabled:
        return
    try:
        maybe_sample()
    except Exception as exc:
        from dbcsr_tpu_torch.obs import events as _events

        if _events.device_error(exc):
            raise


def sample(now: float | None = None, reason: str = "manual") -> dict | None:
    """Take one full sample: scrape every collector, fold in the SLO
    burn gauges `obs.slo` derives from the store, ingest into the
    rings, and append ONE JSONL line to the shard sink (when on).
    Returns the persisted record (or None when the store is off /
    re-entered)."""
    global _last_sample_t, _pending_force, _sampling
    if not _enabled:
        return None
    now = time.time() if now is None else now
    # check-and-set the re-entrancy guard UNDER the lock: a serve
    # admission thread and a multiply's product boundary racing the
    # unlocked flag would both scrape and write duplicate samples
    with _lock:
        if _sampling:
            return None
        _sampling = True
        # consume only the force requests pending NOW: one raised
        # while this sample runs (slo._edge's own burn transition, a
        # detector on another thread) must survive to the NEXT boundary
        gen_at_start = _force_gen
    try:
        pts: list = []
        for fn in _COLLECTORS + tuple(_extra_collectors):
            try:
                pts.extend(fn())
            except Exception as exc:
                # one broken collector must not drop the sample; a
                # device's error is not a collector's to swallow
                from dbcsr_tpu_torch.obs import events as _events

                if _events.device_error(exc):
                    raise
        pts = _sanitize(pts)
        ingest_points(now, pts, persist=False)
        # SLO burn rates are computed OVER the store (including the
        # points just ingested) and ride the same sample
        burn_pts: list = []
        try:
            from dbcsr_tpu_torch.obs import slo as _slo

            burn_pts = _sanitize(_slo.collect(now=now))
            ingest_points(now, burn_pts, persist=False)
        except Exception:
            burn_pts = []
        with _lock:
            _store.seq += 1
            rec = {"seq": _store.seq, "t": now, "reason": reason,
                   "points": [[m, lb, v, k]
                              for m, lb, v, k in pts + burn_pts]}
            _last_sample_t = now
            if _force_gen == gen_at_start:
                _pending_force = None
            if _sink is not None:
                try:
                    _sink.write(json.dumps(rec, default=str) + "\n")
                    _sink.flush()
                except Exception:
                    pass  # a full disk must not fail the multiply
    finally:
        # clear the guard UNDER the lock like the check-and-set above:
        # an unlocked store is unordered against a concurrent CAS
        with _lock:
            _sampling = False
    # the incident-capture boundary: an armed anomaly/SLO-burn trigger
    # (obs.incidents) assembles its bundle HERE — outside the store
    # lock and the sampling guard, carrying the very sample the rising
    # edge forced
    try:
        import sys as _sys

        _inc = _sys.modules.get("dbcsr_tpu_torch.obs.incidents")
        if _inc is not None:
            _inc.on_sample(rec)
    except Exception:
        pass  # capture must never fail the boundary that hosts it
    # the causal-diagnosis boundary (same contract): the RCA knob poll
    # runs BEFORE the change-point scan so a mid-run knob flip is on
    # the change ledger when a shift it caused fires on this sample
    try:
        import sys as _sys

        _rca = _sys.modules.get("dbcsr_tpu_torch.obs.rca")
        if _rca is not None:
            _rca.on_sample(rec)
        _cpm = _sys.modules.get("dbcsr_tpu_torch.obs.changepoint")
        if _cpm is not None:
            _cpm.on_sample(rec)
    except Exception:
        pass  # diagnosis must never fail the boundary that hosts it
    return rec


def ingest_points(t: float, points, persist: bool = True,
                  reason: str = "ingest") -> None:
    """Feed points straight into the rings (tests, `obs.slo`, replay).
    With ``persist`` (and an active sink) the points are also appended
    as one JSONL sample line.  Malformed points are dropped."""
    points = _sanitize(points)
    with _lock:
        _store.ingest(t, points)
        if persist and _sink is not None:
            _store.seq += 1
            rec = {"seq": _store.seq, "t": t, "reason": reason,
                   "points": [[m, lb, v, k] for m, lb, v, k in points]}
            try:
                _sink.write(json.dumps(rec, default=str) + "\n")
                _sink.flush()
            except Exception:
                pass


# --------------------------------------------------------------- query

def _read_shards(base: str) -> list:
    """All sample records of a shard family (or a concrete file),
    oldest first by (t, seq).  Family expansion is the shared
    `obs.shard.expand_family` contract."""
    recs = []
    for path in _shard.expand_family(base):
        try:
            with open(path) as fh:
                for line in fh:
                    try:
                        recs.append(json.loads(line))
                    except ValueError:
                        continue  # torn tail line
        except OSError:
            continue
    recs.sort(key=lambda r: (r.get("t", 0), r.get("seq", 0)))
    return recs


def _replay_store(base: str) -> _Store:
    """Rebuild a store from persisted shards — the SAME ring/tier
    structures the live store holds, so queries agree."""
    st = _Store()
    for rec in _read_shards(base):
        t = rec.get("t")
        pts = rec.get("points")
        if t is None or not isinstance(pts, list):
            continue
        st.ingest(t, pts)  # ingest drops malformed rows itself
    return st


def _agg_value(points: list, agg: str):
    if not points:
        return None
    vs = [p[1] for p in points]
    if agg == "last":
        return points[-1][1]
    if agg == "min":
        return min(vs)
    if agg == "max":
        return max(vs)
    if agg in ("mean", "avg"):
        return sum(vs) / len(vs)
    if agg == "sum":
        return sum(vs)
    if agg == "count":
        return float(len(vs))
    if agg == "rate":
        dt = points[-1][0] - points[0][0]
        dv = points[-1][1] - points[0][1]
        return dv / dt if dt > 0 else 0.0
    raise ValueError(f"unknown agg {agg!r}")


def query(metric: str | None = None, labels: dict | None = None,
          since: float | None = None, until: float | None = None,
          agg: str | None = None, tier="auto",
          path: str | None = None) -> list:
    """Query the live rings (default) or a committed shard family
    (``path=``) — interchangeably, by contract.

    Returns one dict per matching series:
    ``{"metric", "labels", "kind", "tier", "points": [[t, v], ...]}``
    (+ ``"value"`` when ``agg`` is given: last/min/max/mean/sum/count/
    rate over the selected points).  ``since``/``until`` are unix
    seconds; a NEGATIVE ``since`` is relative to now.  ``tier`` is
    ``"raw"``, a tier width (60/600), or ``"auto"``: the finest tier
    whose retention still covers ``since``.
    """
    if since is not None and since < 0:
        since = time.time() + since
    # select and COPY the points under the lock: the sampler appends
    # to the same deques from other threads, and iterating a deque
    # mid-append raises RuntimeError (an HTTP /timeseries scrape must
    # never race a multiply's sample)
    if path is not None:
        store = _replay_store(path)
        with _lock:
            selected = [(s, *_select_points(s, since, tier))
                        for s in store.match(metric, labels)]
    else:
        with _lock:
            selected = [(s, *_select_points(s, since, tier))
                        for s in _store.match(metric, labels)]
    out = []
    for s, sel_tier, pts in selected:
        if since is not None:
            pts = [p for p in pts if p[0] >= since]
        if until is not None:
            pts = [p for p in pts if p[0] <= until]
        ent = {"metric": s.metric, "labels": dict(s.labels),
               "kind": s.kind, "tier": sel_tier,
               "points": [[t, v] for t, v in pts]}
        if agg:
            ent["value"] = _agg_value(ent["points"], agg)
        out.append(ent)
    out.sort(key=lambda e: (e["metric"], sorted(e["labels"].items())))
    return out


def _select_points(s: _Series, since: float | None, tier) -> tuple:
    """(tier_name, [(t, v), ...]) — tier buckets surface their
    ``last`` value (max-merged for counters: never decreasing).
    Callers hold the store lock (the deques are copied here)."""
    if tier in ("raw", 0, None) or (tier == "auto" and since is None):
        return "raw", list(s.raw)
    if tier != "auto":
        w = float(tier)
        if w not in s.tiers:
            raise ValueError(f"unknown tier {tier!r} (raw, 60, 600)")
        return str(int(w)), [(b["t"], b["last"]) for b in s.tiers[w]]
    # "auto": the FINEST candidate that covers `since` — complete
    # (never evicted: holds its whole history) or first retained point
    # predating `since` — AND holds at least 2 in-window points; if no
    # candidate qualifies, the one with the MOST in-window points
    # loses the least (a high-rate store whose raw ring spans less
    # than the window still beats one coarse bucket, and a young
    # process's complete-but-short history is never skipped)
    cands = [("raw", list(s.raw), len(s.raw) < (s.raw.maxlen or 0))]
    for w in TIERS:
        dq = s.tiers[w]
        cands.append((str(int(w)), [(b["t"], b["last"]) for b in dq],
                      len(dq) < (dq.maxlen or 0)))
    counts = [sum(1 for t, _ in pts if t >= since)
              for _, pts, _ in cands]
    for (name, pts, complete), n_in in zip(cands, counts):
        covers = complete or (pts and pts[0][0] <= since)
        if covers and n_in >= 2:
            return name, pts
    best = max(range(len(cands)), key=lambda i: counts[i])
    return cands[best][0], cands[best][1]


def series_list(path: str | None = None) -> list:
    """[{"metric", "labels", "kind", "n_raw"}] of every known series."""
    if path is not None:
        store = _replay_store(path)
        with _lock:
            sers = list(store.series.values())
    else:
        with _lock:
            sers = list(_store.series.values())
    return sorted(
        ({"metric": s.metric, "labels": dict(s.labels), "kind": s.kind,
          "n_raw": len(s.raw)} for s in sers),
        key=lambda e: (e["metric"], sorted(e["labels"].items())))


# ----------------------------------------------------------- persistence

def persist_active() -> bool:
    return _sink is not None


def persist_path() -> str | None:
    """The shard file the sink is currently writing (None when off)."""
    return _sink_path


def enable_persist(base_path: str | None = None) -> str:
    """Open the JSONL shard sink (default base: $DBCSR_TPU_TORCH_TS) — the
    trace/events sharding contract via `obs.shard`.  Implies
    `set_enabled(True)`."""
    global _sink, _sink_base, _sink_path, _sink_pid_final
    base_path = base_path or os.environ.get("DBCSR_TPU_TORCH_TS")
    if not base_path or base_path in ("0", "off", "1"):
        raise ValueError("no timeseries sink path: pass one or set "
                         "DBCSR_TPU_TORCH_TS")
    disable_persist()
    set_enabled(True)
    pid = _shard.process_index()
    with _lock:
        _sink_base = base_path
        _sink_pid_final = pid is not None
        tag = pid if pid is not None else _shard.provisional_tag()
        _sink_path = _shard.shard_path(base_path, tag)
        _sink = open(_sink_path, "a")
    return _sink_path


def disable_persist() -> None:
    """Close the sink, settling a provisional shard name on index 0."""
    global _sink
    rebind(force=True)
    with _lock:
        if _sink is not None:
            try:
                _sink.close()
            except Exception:
                pass
            _sink = None


def rebind(process_index: int | None = None, force: bool = False) -> None:
    """Settle a provisionally-named shard onto its final ``p{index}``
    name (the `tracer.rebind` contract: called by `init_multihost`,
    ``force`` settles on 0 at close).  Appends onto an existing final
    shard instead of clobbering it (`obs.shard.settle`)."""
    global _sink, _sink_path, _sink_pid_final
    with _lock:
        if _sink is None or _sink_pid_final:
            return
        if process_index is None:
            process_index = _shard.process_index()
        if process_index is None:
            if not force:
                return
            process_index = 0
        _sink_pid_final = True
        _sink_path, _sink = _shard.settle(
            _sink_base, _sink_path, _sink, int(process_index))


import atexit


@atexit.register
def _atexit_close() -> None:  # pragma: no cover - process teardown
    try:
        disable_persist()
    except Exception:
        pass


# env activation: DBCSR_TPU_TORCH_TS=<path> at import streams samples to
# disk with no code changes anywhere (mirrors DBCSR_TPU_TORCH_EVENTS)
if _enabled and _env and _env != "1":
    try:
        enable_persist(_env)
    except (ValueError, OSError):
        pass
