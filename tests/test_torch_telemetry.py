"""The telemetry, health and diagnosis plane of the port (obs/windows,
timeseries, slo, health, attribution, incidents, changepoint, rca, the
watchdog and lockcheck), held against the JAX package on the CPU.

The same seeded inputs go through both packages: integers, keys,
verdicts, reasons and rankings must be identical, floats within 1e-12
relative.  Beside the parity cases, the port's own decisions are
checked: rates from device seconds only (an unsynchronized rollup
never reaches the store's rate series or the collapse detector), the
health verdict's breaker rule on the chain the breaker's stacks take,
config fields polled as watched knobs, incident bundles in memory
unless a directory is named, and hooks that swallow their own errors
but never a device's.

Every test resets, before and after, both packages' health windows and
detector states, telemetry stores, SLO, change-point and RCA state and
ledgers, incident budgets, tuner services, faults, breakers, metrics,
events and flight rings.
"""

import json
import math
import os
import random
import threading
import time
import types

import numpy as np
import pytest

from dbcsr_tpu.obs import attribution as jax_attr
from dbcsr_tpu.obs import changepoint as jax_cp
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import flight as jax_flight
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import incidents as jax_incidents
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import rca as jax_rca
from dbcsr_tpu.obs import shard as jax_shard
from dbcsr_tpu.obs import slo as jax_slo
from dbcsr_tpu.obs import timeseries as jax_ts
from dbcsr_tpu.obs import windows as jax_windows
from dbcsr_tpu.core import stats as jax_stats
from dbcsr_tpu.resilience import breaker as jax_breaker
from dbcsr_tpu.resilience import faults as jax_faults
from dbcsr_tpu.resilience import sites as jax_sites
from dbcsr_tpu.resilience import watchdog as jax_watchdog
from dbcsr_tpu.tune import service as jax_tune_service
from dbcsr_tpu.utils import lockcheck as jax_lockcheck

import dbcsr_tpu_torch.obs as obs
from dbcsr_tpu_torch.acc import smm as port_smm
from dbcsr_tpu_torch.core import lib, stats
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.mm import format_planner
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.obs import attribution, changepoint, events, flight, health
from dbcsr_tpu_torch.obs import incidents, metrics, profiler, rca, shard, slo
from dbcsr_tpu_torch.obs import timeseries as ts
from dbcsr_tpu_torch.obs import windows
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.resilience import breaker, faults, sites, watchdog
from dbcsr_tpu_torch.tune import service as tune_service
from dbcsr_tpu_torch.utils import lockcheck

SIZES = [5, 3, 5, 3, 5]
_CFG = ("mm_format", "mm_driver", "incremental", "precision", "mm_stack_size")


def _reset_both() -> None:
    for f in (faults, jax_faults):
        f.clear()
    for b in (breaker, jax_breaker):
        b.reset_board()
    # metrics.reset also resets stats, attribution, incidents, profiler,
    # changepoint and rca in each package
    for m in (metrics, jax_metrics):
        m.reset()
    for mod in (events, jax_events, flight, jax_flight):
        mod.clear()
    for mod in (health, jax_health, ts, jax_ts, slo, jax_slo, changepoint, jax_cp,
                rca, jax_rca, incidents, jax_incidents, attribution, jax_attr,
                lockcheck, jax_lockcheck):
        mod.reset()
    for svc in (tune_service, jax_tune_service):
        svc.stop_service()
    port_smm._cross_disabled.clear()
    port_smm._breaker_chains.clear()
    format_planner.reset()
    mm.clear_plan_cache()


@pytest.fixture(autouse=True)
def clean_both(monkeypatch):
    cfg = {k: getattr(get_config(), k) for k in _CFG}
    for name in ("DBCSR_TPU_TORCH_SYNC_TIMING", "DBCSR_TPU_SYNC_TIMING",
                 "DBCSR_TPU_TORCH_INCIDENTS", "DBCSR_TPU_TORCH_TS_INTERVAL_S",
                 "DBCSR_TPU_TS_INTERVAL_S"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("DBCSR_TPU_INCIDENTS", "0")
    _reset_both()
    set_config(incremental="off")
    yield
    _reset_both()
    set_config(**cfg)
    assert health.verdict()["status"] == "OK"
    assert jax_health.verdict()["status"] == "OK"


def _close(a, b, rel=1e-12):
    if isinstance(a, dict):
        assert set(a) == set(b), (a, b)
        for k in a:
            _close(a[k], b[k], rel)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _close(x, y, rel)
    elif isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            assert a == b
        else:
            assert math.isclose(a, b, rel_tol=rel, abs_tol=1e-300), (a, b)
    else:
        assert a == b, (a, b)


def _product(seed=3, device="cpu"):
    rng = np.random.default_rng(seed)
    a, b, c = (port_tm.make_random_matrix(n, SIZES, SIZES, occupation=o, rng=rng, device=device)
               for n, o in (("A", 0.7), ("B", 0.7), ("C", 0.4)))
    mm.multiply("N", "N", 1.0, a, b, 0.5, c)
    return c


# ------------------------------------------------------------- windows
@pytest.mark.parametrize("seed,n", [(0, 1), (1, 2), (2, 7), (3, 64), (4, 0)])
def test_windows_match_jax(seed, n):
    xs = list(np.random.default_rng(seed).standard_normal(n) * 10)
    assert windows.median(xs) == jax_windows.median(xs)
    assert windows.mad(xs) == jax_windows.mad(xs)
    for q in (0.0, 0.5, 0.95, 1.0):
        assert windows.rank_quantile(sorted(xs), q) == jax_windows.rank_quantile(sorted(xs), q)
    assert windows.p50_p95(xs) == jax_windows.p50_p95(xs)
    w, jw = windows.Window(5), jax_windows.Window(5)
    for x in xs:
        w.append(x)
        jw.append(x)
        assert (w.sum, len(w), w.mean()) == (jw.sum, len(jw), jw.mean())
    assert list(w) == list(jw)


# ----------------------------------------------------- timeseries store
def _seeded_points(seed=5, n=400, t0=1_000_000.0):
    """(t, points) rows: a gauge, a counter with a drop-in-bucket
    scrape, labelled series."""
    rng = np.random.default_rng(seed)
    rows, count = [], 0.0
    for i in range(n):
        t = t0 + i * 7.3 + float(rng.random())
        count += float(rng.integers(0, 5))
        pts = [("g", {"driver": "pallas"}, float(rng.standard_normal()), "gauge"),
               ("c", {}, count, "counter"),
               ("c", {"x": "1"}, count * 2.0, "counter")]
        if i % 11 == 0:  # an out-of-order scrape inside an open bucket
            pts.append(("c", {}, max(count - 3.0, 0.0), "counter"))
        rows.append((t, pts))
    return rows


@pytest.mark.parametrize("tier", ["raw", 60, 600, "auto"])
def test_store_tiers_match_jax(tier):
    rows = _seeded_points()
    for mod in (ts, jax_ts):
        for t, pts in rows:
            mod.ingest_points(t, pts, persist=False)
    since = rows[-1][0] - 1500.0 if tier == "auto" else None
    got = ts.query(tier=tier, since=since)
    want = jax_ts.query(tier=tier, since=since)
    assert got == want
    assert ts.series_list() == jax_ts.series_list()
    for agg in ("last", "min", "max", "mean", "sum", "count", "rate"):
        _close(ts.query("g", tier=tier, since=since, agg=agg),
               jax_ts.query("g", tier=tier, since=since, agg=agg))


def test_counter_never_decreases_across_a_downsample():
    for t, pts in _seeded_points(seed=9):
        ts.ingest_points(t, pts, persist=False)
    for tier in (60, 600):
        for ser in ts.query("c", tier=tier):
            vals = [v for _, v in ser["points"]]
            assert vals == sorted(vals) and len(vals) > 3


def test_store_replay_matches_live_and_jax(tmp_path):
    rows = _seeded_points(n=120)
    paths = []
    for mod, base in ((ts, tmp_path / "port.jsonl"), (jax_ts, tmp_path / "jax.jsonl")):
        mod.enable_persist(str(base))
        try:
            for t, pts in rows:
                mod.ingest_points(t, pts, persist=True)
        finally:
            mod.disable_persist()
        paths.append(str(base))
    assert os.path.exists(shard.shard_path(paths[0], 0))
    live = ts.query(tier="raw")
    assert ts.query(tier="raw", path=paths[0]) == live
    assert jax_ts.query(tier="raw", path=paths[1]) == live
    assert ts.query(tier=60, path=paths[0]) == ts.query(tier=60)
    assert shard.expand_family(paths[0]) == [shard.shard_path(paths[0], 0)]
    assert [os.path.basename(p) for p in shard.expand_family(paths[1])] == \
        [os.path.basename(p) for p in jax_shard.expand_family(paths[1])]


def test_sample_collects_engine_series_from_device_seconds_only(monkeypatch):
    """Decision 1: rates come from synchronized regions only."""
    stats.record_driver("pallas", 10**9, nbytes=10**8, seconds=0.5, dtype="float64")
    rec = ts.sample(now=1000.0)
    names = {p[0] for p in rec["points"]}
    assert "dbcsr_tpu_dispatch_seconds_total" in names
    assert "dbcsr_tpu_roofline_fraction" not in names
    assert "dbcsr_tpu_achieved_gflops" not in names
    stats.record_driver("pallas", 10**9, nbytes=10**8, seconds=0.25, dtype="float64",
                        sync=True)
    pts = {p[0]: p for p in ts.sample(now=1010.0)["points"]
           if p[1].get("driver") == "pallas"}
    assert pts["dbcsr_tpu_achieved_gflops"][2] == pytest.approx(4.0)
    # the same synchronized region in the JAX package gives the same rate
    jax_stats.record_driver("pallas", 10**9, nbytes=10**8, seconds=0.25, dtype="float64")
    jpts = {p[0]: p for p in jax_ts._collect_engine() if p[1].get("driver") == "pallas"}
    _close(pts["dbcsr_tpu_roofline_fraction"][2], jpts["dbcsr_tpu_roofline_fraction"][2])


def test_rates_read_the_least_bytes_convention(monkeypatch):
    """Decision 2: the bytes behind every rate the store, the SLO floor,
    the collapse detector and the miner read are the least bytes a
    launch moves (`stack_min_bytes`), below the JAX package's per-entry
    gathers for the same stack."""
    from dbcsr_tpu_torch.obs import costmodel

    monkeypatch.setenv("DBCSR_TPU_TORCH_SYNC_TIMING", "1")
    rng = np.random.default_rng(7)
    a, b = (port_tm.make_random_matrix(n, [4] * 8, [4] * 8, occupation=0.9, rng=rng,
                                       device="cpu") for n in "AB")
    c = port_tm.make_random_matrix("C", [4] * 8, [4] * 8, occupation=0.0, rng=rng,
                                   device="cpu")
    set_config(mm_format="stack")
    mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    row = stats.driver_rollup()["pallas"]
    (m, n, k, entries) = c._mm_spans[0][:4]
    assert len(c._mm_spans) == 1 and row["sync_flops"] == 2 * m * n * k * entries
    gathers = costmodel.stack_bytes(m, n, k, entries, nseg=int(c.nblks), itemsize=8)
    assert 0 < row["sync_bytes"] < gathers
    frac = ts._collect_engine()
    frac = [p_[2] for p_ in frac if p_[0] == "dbcsr_tpu_roofline_fraction"][0]
    want = costmodel.roofline(row["sync_flops"], row["sync_bytes"], row["sync_seconds"],
                              kind=costmodel.device_kind(), dtype="float64")
    assert frac == want["roofline_fraction"]


def test_product_boundary_feeds_health_and_the_store(monkeypatch):
    monkeypatch.setenv("DBCSR_TPU_TORCH_TS_INTERVAL_S", "0")
    monkeypatch.setenv("DBCSR_TPU_TORCH_SYNC_TIMING", "1")
    for seed in range(3):
        _product(seed)
    assert health.verdict()["window"] == 3
    names = {s["metric"] for s in ts.series_list()}
    assert {"dbcsr_tpu_multiplies_total", "dbcsr_tpu_cell_flops_total",
            "dbcsr_tpu_health_status", "dbcsr_tpu_multiply_seconds_total"} <= names
    assert ts.query("dbcsr_tpu_multiplies_total", agg="last")[0]["value"] == 3.0
    # on the CPU the synchronized seconds give a rate series
    assert ts.query("dbcsr_tpu_roofline_fraction")


def test_hooks_swallow_bookkeeping_errors_never_a_device_error(monkeypatch):
    """Decision 9."""
    def broken(**kw):
        raise ValueError("bookkeeping bug")

    monkeypatch.setattr(health, "observe_multiply", broken)
    _product()  # a broken health sample never fails the multiply

    def device(**kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(health, "observe_multiply", device)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _product()
    assert events.current_product() is None  # the product still popped
    monkeypatch.undo()
    monkeypatch.setenv("DBCSR_TPU_TORCH_TS_INTERVAL_S", "0")
    ts.register_collector(lambda: [("x", {}, 1.0, "gauge")] + [None])
    ts.register_collector(lambda: (_ for _ in ()).throw(KeyError("collector bug")))
    _product()
    assert ts.query("x")
    ts.reset()
    ts.register_collector(lambda: (_ for _ in ()).throw(
        RuntimeError("CUDA error: device-side assert triggered")))
    with pytest.raises(RuntimeError, match="device-side assert"):
        _product()
    assert events.device_error(RuntimeError("CUDA out of memory. Tried"))
    assert not events.device_error(ValueError("shape mismatch"))


def test_a_failing_multiply_still_raises_and_is_observed(monkeypatch):
    def body(*args):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(mm, "_multiply_body", body)
    with pytest.raises(RuntimeError, match="unspecified launch failure"):
        _product()
    assert "launch failure" in events.records(kind="multiply_end")[-1]["error"]
    assert health._samples[-1]["dur_ms"] is None  # kept out of the latency window


# --------------------------------------------------------------- slo
def _burn_points(now):
    rows = []
    for i in range(40):
        t = now - 590.0 + i * 15.0
        frac = 0.001 if i % 3 else 0.01
        rows.append((t, [("dbcsr_tpu_roofline_fraction", {"driver": "pallas"}, frac, "gauge"),
                         ("dbcsr_tpu_abft_checks_total", {"driver": "pallas"}, 10.0 * i,
                          "counter"),
                         ("dbcsr_tpu_abft_mismatches_total", {"driver": "pallas"},
                          float(i // 10), "counter"),
                         ("dbcsr_tpu_abft_recoveries_total", {"driver": "pallas"},
                          float(i // 20), "counter")]))
    return rows


def test_slo_burn_rates_match_jax():
    now = time.time()
    for mod in (ts, jax_ts):
        for t, pts in _burn_points(now):
            mod.ingest_points(t, pts, persist=False)
    got, want = slo.evaluate(now=now), jax_slo.evaluate(now=now)
    _close(got, want)
    assert got["roofline_floor"]["status"] == "BURNING"
    assert got["serve_errors"]["status"] == "NO_DATA"
    pts = slo.collect(now=now)
    _close(pts, jax_slo.collect(now=now))
    comp, jcomp = slo.component(), jax_slo.component()
    assert comp["status"] == jcomp["status"] == "DEGRADED"
    assert [r.replace("DBCSR_TPU_TORCH_", "DBCSR_TPU_") for r in comp["reasons"]] == \
        jcomp["reasons"]
    assert metrics.counter_items("dbcsr_tpu_slo_burn_total") == \
        jax_metrics.counter_items("dbcsr_tpu_slo_burn_total")
    assert [r["objective"] for r in events.records(kind="slo_burn")] == \
        [r["objective"] for r in jax_events.records(kind="slo_burn")] == ["roofline_floor"]
    slo.reset()
    jax_slo.reset()


# ------------------------------------------------------------ health
def _open(board, driver, key):
    for _ in range(board.fail_threshold):
        board.record_failure(driver, key)


@pytest.mark.parametrize("jax_driver,port_driver", [("pallas", "pallas"), ("xla", "torch"),
                                                    ("host", "host")])
def test_open_breaker_verdict_matches_jax(jax_driver, port_driver):
    """Decision 3, CPU chain: the plain version ``torch`` stands where
    the JAX package's safe ``xla`` stands."""
    key = (5, 5, 5, "float64")
    _open(breaker.get_board(), port_driver, key)
    _open(jax_breaker.get_board(), jax_driver, key)
    got = health.verdict()["components"]["drivers"]
    want = jax_health.verdict()["components"]["drivers"]
    assert got["status"] == want["status"]
    assert got["status"] == ("CRITICAL" if jax_driver == "xla" else "DEGRADED")
    assert [r.replace(port_driver, jax_driver) for r in got["reasons"]] == want["reasons"]
    assert health.admission_status() == jax_health.admission_status() == got["status"]
    breaker.reset_board()
    jax_breaker.reset_board()


def test_card_chain_breaker_rule():
    """Decision 3, card chain: an open K1 breaker leaves K3 to serve its
    shape (DEGRADED); no kernel left for a shape is CRITICAL."""
    board = breaker.get_board()
    real = (23, 23, 23, "float64")
    for drv in ("pallas", "pallas_cross"):
        port_smm._breaker_chains[f"{drv}|23x23x23xfloat64"] = "card"
    _open(board, "pallas", real)
    comp = health.verdict()["components"]["drivers"]
    assert comp["status"] == "DEGRADED"
    assert comp["reasons"] == ["breaker open: pallas|23x23x23xfloat64 (runtime)"]
    _open(board, "pallas_cross", real)
    comp = health.verdict()["components"]["drivers"]
    assert comp["status"] == "CRITICAL"
    assert "no hand-written kernel left on the card for 23x23x23xfloat64" in comp["reasons"][1]
    breaker.reset_board()
    port_smm._breaker_chains["pallas|5x5x5xcomplex128"] = "card"
    _open(breaker.get_board(), "pallas", (5, 5, 5, "complex128"))
    assert health.verdict()["components"]["drivers"]["status"] == "CRITICAL"
    breaker.reset_board()
    # a "torch" breaker of a card stack is no CPU backstop
    port_smm._breaker_chains["torch|5x5x5xfloat64"] = "card"
    _open(breaker.get_board(), "torch", (5, 5, 5, "float64"))
    assert health.verdict()["components"]["drivers"]["status"] == "DEGRADED"
    breaker.reset_board()


def test_failing_cpu_launches_record_their_chain():
    rng = np.random.default_rng(1)
    a, b, c = (port_tm.make_random_matrix(n, [4] * 4, [4] * 4, occupation=0.8, rng=rng,
                                          device="cpu") for n in "ABC")
    set_config(mm_driver="pallas", mm_format="stack")
    with faults.inject_faults("pallas:raise"):
        for _ in range(breaker.get_board().fail_threshold):
            mm.clear_plan_cache()  # a cached plan was healed onto the failover driver
            mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    assert port_smm.breaker_chain("pallas|4x4x4xfloat64") == "cpu"
    comp = health.verdict()["components"]["drivers"]
    assert comp["status"] == "DEGRADED" and comp["open"] == 1
    breaker.reset_board()
    metrics.reset()
    health.reset()


def test_wedge_streak_checksum_and_abft_verdicts_match_jax():
    for wd_mod in (watchdog, jax_watchdog):
        wd = wd_mod.Watchdog("mp_world_join", deadline_s=1.0)
        for _ in range(3):
            wd.guard(lambda d: (_ for _ in ()).throw(wd_mod.DeadlineExceeded("late")))
    for m in (metrics, jax_metrics):
        m.counter("dbcsr_tpu_checksum_retry_total").inc(outcome="deterministic")
        m.counter("dbcsr_tpu_abft_mismatches_total").inc(3, driver="pallas")
        m.counter("dbcsr_tpu_abft_recoveries_total").inc(1, driver="pallas")
        m.counter("dbcsr_tpu_chain_rollback_total").inc(2)
        m.counter("dbcsr_tpu_multihost_degraded_total").inc()
    got, want = health.verdict(), jax_health.verdict()
    for name in ("watchdog", "engine", "integrity"):
        g, w = got["components"][name], want["components"][name]
        assert g["status"] == w["status"] == "CRITICAL", name
        assert g["reasons"] == w["reasons"], name
    assert got["components"]["watchdog"]["wedge_streaks"] == {"mp_world_join": 3}
    assert got["status"] == want["status"] == "CRITICAL"
    for m in (metrics, jax_metrics):
        m.reset()


def _feed_detectors(mod, metrics_mod, durs, compiles, fallbacks):
    for d, nc, nf in zip(durs, compiles, fallbacks):
        if nc:
            metrics_mod.counter("dbcsr_tpu_jit_compiles_total").inc(nc, fn="k")
        if nf:
            metrics_mod.counter("dbcsr_tpu_driver_fallback_total").inc(nf)
        mod.observe_multiply(dur_ms=d)


def test_anomaly_detectors_match_jax():
    """Decision 4: the JAX semantics of the storm detectors, fed the same
    sequence (a warm-up of first-use validations, then steady state)."""
    rng = np.random.default_rng(11)
    durs = list(40.0 + rng.random(40))
    durs[30] = 400.0
    compiles = [3] * 10 + [0] * 30
    fallbacks = [0] * 20 + [1] * 10 + [0] * 10
    fired, jfired = [], []
    for i in range(40):
        _feed_detectors(health, metrics, durs[i:i + 1], compiles[i:i + 1], fallbacks[i:i + 1])
        _feed_detectors(jax_health, jax_metrics, durs[i:i + 1], compiles[i:i + 1],
                        fallbacks[i:i + 1])
        fired.append(sorted(health.active_anomalies()))
        jfired.append(sorted(jax_health.active_anomalies()))
    assert fired == jfired
    assert "recompile_storm" in fired[9] and "fallback_storm" in fired[29]
    assert "dispatch_latency_spike" in fired[30]
    assert health.verdict()["anomaly_counts"] == jax_health.verdict()["anomaly_counts"]
    assert [e["kind"] for e in events.records(kind="anomaly")] == \
        [e["kind"] for e in jax_events.records(kind="anomaly")]
    for m in (metrics, jax_metrics):
        m.reset()
    health.reset()
    jax_health.reset()


def _collapse_feed(sync: bool, jax=False):
    """12 multiplies at a steady rate, then one at a tenth of it."""
    mod_stats = jax_stats if jax else stats
    mod_health = jax_health if jax else health
    for i in range(13):
        secs = 0.1 if i < 12 else 1.0
        if jax:
            mod_stats.record_driver("pallas", 10**9, nbytes=10**7, seconds=secs,
                                    dtype="float64")
        else:
            mod_stats.record_driver("pallas", 10**9, nbytes=10**7, seconds=secs,
                                    dtype="float64", sync=sync)
        mod_health.observe_multiply(dur_ms=10.0)


def test_roofline_collapse_reads_device_seconds_only():
    """Decision 1: with synchronized seconds the detector matches the JAX
    package's; dispatch seconds never feed it."""
    _collapse_feed(sync=True)
    _collapse_feed(sync=True, jax=True)
    assert health.active_anomalies() == jax_health.active_anomalies() == \
        {"roofline_collapse": ["pallas"]}
    got = [e for e in events.records(kind="anomaly")]
    want = [e for e in jax_events.records(kind="anomaly")]
    _close([{k: e[k] for k in ("kind", "driver", "fraction", "window_median")} for e in got],
           [{k: e[k] for k in ("kind", "driver", "fraction", "window_median")} for e in want])
    for m in (metrics, jax_metrics):
        m.reset()
    health.reset()
    jax_health.reset()
    _collapse_feed(sync=False)
    assert health.active_anomalies() == {}
    assert health._rl_hist == {}
    assert health.verdict()["components"]["perf"]["roofline_fraction"] == {}
    metrics.reset()
    health.reset()


# -------------------------------------------------------- attribution
def _req(i, tenant):
    return types.SimpleNamespace(request_id=f"r{i}", tenant=tenant, op="multiply")


def test_attribution_bills_exactly_like_jax():
    rng = np.random.default_rng(4)
    reqs = [_req(i, f"t{i % 3}") for i in range(7)]
    for mod, st in ((attribution, stats), (jax_attr, jax_stats)):
        mod.reset()
        for r in reqs:
            mod.on_submit(r)
    draws = [(int(rng.integers(1, 10**9)), int(rng.integers(1, 10**8)),
              float(rng.random()), [int(x) for x in rng.integers(0, 9, 3)])
             for _ in range(5)]
    for mod, st in ((attribution, stats), (jax_attr, jax_stats)):
        for j, (fl, nb, secs, w) in enumerate(draws):
            tok = mod.begin_window()
            st.record_driver("pallas", fl, nbytes=nb, seconds=secs, dtype="float64")
            mod.bill_window(tok, reqs[j:j + 3], weights=w)
        mod.credit_saved(reqs[0], 12345, seconds=0.001)
        for r in reqs:
            mod.on_terminal(r, "done")
            mod.on_terminal(r, "done")  # counted once
    got, want = attribution.usage(), jax_attr.usage()
    assert got == want
    cons = attribution.conservation()
    assert cons["grand"] == jax_attr.conservation()["grand"]
    assert cons["tenant_sum"] == {k: cons["grand"][k] for k in cons["tenant_sum"]}
    assert cons["grand"]["flops"] == cons["rollup"]["flops"] == sum(d[0] for d in draws)
    assert attribution.request_info("r1")["billed"] == jax_attr.request_info("r1")["billed"]
    assert metrics.counter_items("dbcsr_tpu_tenant_flops_total") == \
        jax_metrics.counter_items("dbcsr_tpu_tenant_flops_total")
    with faults.inject_faults("attribution:raise,times=1") as specs:
        tok = attribution.begin_window()
        stats.record_driver("pallas", 10, dtype="float64")
        attribution.bill_window(tok, reqs[:1])
    assert specs[0].fired == 1
    cons = attribution.conservation()
    assert cons["grand"]["flops"] == cons["rollup"]["flops"]


# ---------------------------------------------------------- incidents
def test_incident_rate_limits_match_jax(tmp_path, monkeypatch):
    for pre, d in (("DBCSR_TPU_TORCH_", "port"), ("DBCSR_TPU_", "jax")):
        monkeypatch.setenv(pre + "INCIDENTS", str(tmp_path / d))
        monkeypatch.setenv(pre + "INCIDENT_N", "2")
        monkeypatch.setenv(pre + "INCIDENT_INTERVAL_S", "0")
    outcomes = []
    for mod, ev in ((incidents, events), (incidents and jax_incidents, jax_events)):
        ev.publish("driver_failure", {"driver": "pallas"})
        out = []
        for i in range(4):
            out.append(mod.trigger(f"anomaly:k{i}", {"i": i}))
            out.append(mod.trigger("second", {}))  # armed already: kept first
            out.append(bool(mod.on_sample({"t": 1.0, "points": []})))
        out.append([b["reason"] for b in mod.bundles()])
        outcomes.append(out)
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][-1] == ["anomaly:k0", "anomaly:k1"]
    assert metrics.counter_items("dbcsr_tpu_incident_bundles_total") == \
        jax_metrics.counter_items("dbcsr_tpu_incident_bundles_total")
    files = sorted(os.listdir(tmp_path / "port"))
    assert len(files) == 2 and files[0].startswith("incident-anomaly_k0-")
    recs = [json.loads(x)["rec"] for x in open(tmp_path / "port" / files[0])]
    jfile = sorted(os.listdir(tmp_path / "jax"))[0]
    jrecs = [json.loads(x)["rec"] for x in open(tmp_path / "jax" / jfile)]
    assert recs[:3] == jrecs[:3] == ["meta", "health", "sample"]
    assert "event" in recs


def test_incident_bundles_stay_in_memory_unless_a_directory_is_named(tmp_path,
                                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert incidents._dir() is None
    incidents.trigger("anomaly:x")
    assert incidents.on_sample({"t": 0.0}) is None
    assert incidents.bundles()[0]["reason"] == "anomaly:x"
    assert os.listdir(tmp_path) == []


# --------------------------------------------------------- changepoint
def _level_series(seed=2):
    rng = np.random.default_rng(seed)
    return [(100.0 + 10.0 * i, (40.0 if i < 20 else 70.0) + float(rng.standard_normal()))
            for i in range(40)]


def test_changepoint_shift_time_and_magnitude_match_jax():
    got = [changepoint.observe("multiply_latency_ms", {}, t, v) for t, v in _level_series()]
    want = [jax_cp.observe("multiply_latency_ms", {}, t, v) for t, v in _level_series()]
    fired = [(i, g) for i, g in enumerate(got) if g]
    assert [i for i, _ in fired] == [i for i, w in enumerate(want) if w]
    assert fired, "no change-point"
    for (_, g), w in zip(fired, [w for w in want if w]):
        _close(g, w)
    cp = fired[0][1]
    assert cp["direction"] == "up" and cp["regression"] and cp["t_shift"] == 300.0
    assert 25.0 < cp["magnitude"] < 35.0
    _close(changepoint.state(), jax_cp.state())


def test_changepoint_on_sample_derives_the_ratio_series():
    recs = []
    tot_s = tot_n = 0.0
    for i, (t, ms) in enumerate(_level_series(seed=8)):
        tot_s += ms / 1e3
        tot_n += 1
        recs.append({"t": t, "points": [
            ["dbcsr_tpu_multiply_seconds_total", {}, tot_s, "counter"],
            ["dbcsr_tpu_profiled_multiplies_total", {}, tot_n, "counter"]]})
    for r in recs:
        changepoint.on_sample(r)
        jax_cp.on_sample(r)
    _close(changepoint.changepoints(), jax_cp.changepoints())
    assert changepoint.changepoints(regressions_only=True)


# ----------------------------------------------------------------- rca
_LEDGER = [
    {"t": 250.0, "kind": "knob_change", "knob": "mm_format", "value": "stack", "prev": "auto"},
    {"t": 120.0, "kind": "tune_promotion", "driver": "pallas", "mnk": "23x23x23"},
    {"t": 295.0, "kind": "breaker_transition", "driver": "pallas_cross", "state": "open"},
    {"t": 320.0, "kind": "format_decision", "format": "dense", "reason": "tuned"},
    {"t": 10.0, "kind": "worker_up", "worker": "w1"},
]


@pytest.mark.parametrize("labels", [{}, {"driver": "pallas"}])
def test_rca_scores_on_the_same_ledger_match_jax(labels):
    for mod in (rca, jax_rca):
        for ent in _LEDGER:
            mod._ledger.append(dict(ent))
    cp = {"series": "achieved_gflops", "labels": labels, "t": 330.0, "t_shift": 300.0,
          "direction": "down", "magnitude": -5.0, "regression": True}
    got, want = rca.on_changepoint(dict(cp)), jax_rca.on_changepoint(dict(cp))
    assert got["top_cause"] == want["top_cause"]
    assert [c["kind"] for c in got["causes"]] == [c["kind"] for c in want["causes"]]
    _close([c["score"] for c in got["causes"]], [c["score"] for c in want["causes"]])
    assert incidents.pending() == "rca:achieved_gflops"
    assert metrics.counter_items("dbcsr_tpu_rca_reports_total") == \
        jax_metrics.counter_items("dbcsr_tpu_rca_reports_total")


def test_watched_config_fields_become_knob_changes():
    """Decision 5: the config fields are polled at the sample boundary."""
    set_config(mm_format="auto")
    rca.on_sample({"t": 1.0})
    assert rca.ledger() == []
    set_config(mm_format="stack", mm_stack_size=1000)
    rca.on_sample({"t": 2.0})
    got = {e["knob"]: (e["prev"], e["value"]) for e in rca.ledger(kind="knob_change")}
    assert got == {"mm_format": ("auto", "stack"), "mm_stack_size": ("30000", "1000")}
    assert events.records(kind="knob_change")


def test_a_step_is_attributed_end_to_end(monkeypatch, tmp_path):
    """The telemetry phase's chain on the CPU: a latency step after a
    format change fires a change-point in the regressing direction,
    RCA names the knob change, and an incident bundle lands."""
    monkeypatch.setenv("DBCSR_TPU_TORCH_INCIDENTS", str(tmp_path))
    monkeypatch.setenv("DBCSR_TPU_TORCH_INCIDENT_INTERVAL_S", "0")
    t = [1000.0]

    def sample_at(ms):
        profiler._totals["n"] += 1
        profiler._totals["ms"] += ms
        t[0] += 1.0
        ts.sample(now=t[0])

    for _ in range(14):
        sample_at(40.0)
    set_config(mm_format="stack")
    for _ in range(8):
        sample_at(75.0)
    cps = changepoint.changepoints(series="multiply_latency_ms", regressions_only=True)
    assert cps and cps[0]["direction"] == "up" and cps[0]["magnitude"] > 20.0
    rep = rca.reports()[-1]
    assert rep["top_cause"] == "knob_change" and rep["causes"][0]["knob"] == "mm_format"
    files = os.listdir(tmp_path)
    assert any(f.startswith("incident-rca_multiply_latency_ms") for f in files), files


# ----------------------------------------------------------- watchdog
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("elapsed,err,outcome", [
    (0.1, None, "OK"), (0.8, None, "SLOW"), (0.1, ValueError("x"), "TRANSIENT"),
    (0.1, TimeoutError("t"), "WEDGED")])
def test_watchdog_outcomes_match_jax(elapsed, err, outcome):
    for mod in (watchdog, jax_watchdog):
        clock = _Clock()
        wd = mod.Watchdog("chan", deadline_s=1.0, clock=clock, sleep=lambda s: None)

        def fn(deadline, clock=clock):
            clock.t += elapsed
            if err is not None:
                raise err
            return 7

        res = wd.guard(fn)
        assert res.outcome == outcome and wd.classify(elapsed, err) == outcome
        assert res.ok == (outcome in ("OK", "SLOW"))
    assert metrics.counter_items("dbcsr_tpu_watchdog_outcomes_total") == \
        jax_metrics.counter_items("dbcsr_tpu_watchdog_outcomes_total")


def test_watchdog_backoff_delays_and_resume_match_jax(tmp_path):
    delays = []
    for mod, name in ((watchdog, "port"), (jax_watchdog, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        wd = mod.Watchdog("mp_world_join", deadline_s=1.0, backoff_base_s=1.0,
                          backoff_max_s=15.0, state_path=path, sleep=lambda s: None)
        out = [wd.next_delay()]
        for i in range(5):
            wd.guard(lambda d, i=i: (_ for _ in ()).throw(
                TimeoutError("x") if i % 2 else ValueError("y")))
            out.append(wd.next_delay())
        again = mod.Watchdog("mp_world_join", deadline_s=1.0, state_path=path)
        out.append((again.streak, again.wedge_streak, again.last_outcome))
        res = mod.Watchdog("c", deadline_s=1.0, sleep=lambda s: None, rng=random.Random(3)).run(
            lambda d: (_ for _ in ()).throw(TimeoutError("z")), retries=2)
        out.append((res.outcome, res.attempts))
        delays.append(out)
    assert delays[0] == delays[1]
    assert delays[0][-1] == ("WEDGED", 3)


def test_rotate_jsonl_keeps_every_channels_last_record(tmp_path):
    for mod, name in ((watchdog, "port"), (jax_watchdog, "jax")):
        path = tmp_path / f"{name}.jsonl"
        with open(path, "w") as fh:
            for i in range(200):
                fh.write(json.dumps({"name": f"c{i % 3}", "i": i, "pad": "x" * 40}) + "\n")
        assert mod.rotate_jsonl(str(path), max_bytes=2000)
    a = open(tmp_path / "port.jsonl").read()
    assert a == open(tmp_path / "jax.jsonl").read()
    assert {json.loads(x)["name"] for x in a.splitlines()} == {"c0", "c1", "c2"}


def test_mp_world_join_retries_a_wedged_world_once(monkeypatch):
    from dbcsr_tpu_torch.parallel import multihost
    from dbcsr_tpu_torch.perf import driver

    calls = []
    rank = {"checksum": 1.5, "flops": 10, "time_best_s": 1.0, "gflops_mean": 1.0}

    def spawn(task, nproc, args, timeout_s):
        calls.append(timeout_s)
        if len(calls) == 1:
            raise TimeoutError("world did not finish")
        return [dict(rank, rank=r) for r in range(nproc)]

    monkeypatch.setattr(multihost, "spawn_world", spawn)
    monkeypatch.setattr(watchdog.time, "sleep", lambda s: None)
    agg = driver.run_perf_multiproc("x.perf", 2, timeout=5.0, verbose=False, device="cpu")
    assert agg["checksum"] == 1.5 and calls == [5.0, 5.0]
    got = {lb["outcome"]: v for lb, v in metrics.counter_items(
        "dbcsr_tpu_watchdog_outcomes_total") if lb["name"] == "mp_world_join"}
    assert got == {"WEDGED": 1.0, "OK": 1.0}

    def failing(task, nproc, args, timeout_s):
        raise RuntimeError("rank 1 failed")

    monkeypatch.setattr(multihost, "spawn_world", failing)
    with pytest.raises(RuntimeError, match="TRANSIENT"):
        driver.run_perf_multiproc("x.perf", 2, timeout=5.0, verbose=False, device="cpu")
    metrics.reset()
    health.reset()


# ----------------------------------------------------------- lockcheck
def test_lock_order_inversion_raises_like_jax(monkeypatch):
    monkeypatch.setenv("DBCSR_TPU_TORCH_LOCKCHECK", "1")
    monkeypatch.setenv("DBCSR_TPU_LOCKCHECK", "1")
    msgs = []
    for mod in (lockcheck, jax_lockcheck):
        a, b = mod.wrap("a", threading.Lock()), mod.wrap("b", threading.RLock())
        assert isinstance(a, mod.TrackedLock)
        with a:
            with b:
                assert mod.held_names() == ("a", "b")
        with b:
            with pytest.raises(mod.LockOrderError) as err:
                a.acquire()
            msgs.append(str(err.value))
        assert not a.locked()
    assert msgs[0] == msgs[1] and "lock order inversion" in msgs[0]
    monkeypatch.delenv("DBCSR_TPU_TORCH_LOCKCHECK")
    raw = threading.Lock()
    assert lockcheck.wrap("x", raw) is raw


# ------------------------------------------------- obs core leftovers
def test_obs_core_leftovers_match_jax():
    assert flight.ring_capacity() == jax_flight.ring_capacity()
    events.publish("tune_trial", {"mnk": "4x4x4"})
    assert json.loads(events.to_json(kind="tune_trial"))[0]["mnk"] == "4x4x4"
    assert profiler.enabled() and profiler.epoch_n() == 64
    profiler.set_enabled(False)
    _product()
    assert profiler.totals()["n"] == 0
    profiler.reset()
    assert profiler.enabled()
    for site in ("attribution", "tune_trial"):
        assert site in sites.SITES and site in sites.chaos_sites()
        assert {k: v for k, v in sites.SITES[site].items() if k != "boundary"} == \
            {k: v for k, v in jax_sites.SITES[site].items() if k != "boundary"}
    assert set(sites.chaos_corrupt_targets()) <= set(sites.chaos_sites())


def test_finalize_prints_the_health_verdict():
    events.publish("x", {})
    lines = []
    lib.finalize_lib(print_stats=True, out=lines.append)
    snap = json.loads(lines[-1])
    assert snap["health"]["status"] == "OK"
    assert set(snap["health"]["components"]) == {"drivers", "watchdog", "engine", "perf",
                                                "integrity", "slo", "tune", "fleet"}


def test_metrics_reset_resets_the_diagnosis_plane():
    changepoint.observe("fallback_rate", {}, 1.0, 1.0)
    rca._ledger.append({"t": 1.0, "kind": "worker_up"})
    incidents.trigger("x")
    attribution.on_submit(_req(0, "t"))
    metrics.reset()
    assert changepoint.state() == {} and rca.ledger() == []
    assert incidents.pending() is None and attribution.ledger_size() == 0


def test_package_exports_the_plane():
    for name in ("windows", "timeseries", "slo", "health", "changepoint", "rca"):
        assert name in obs.__all__ and hasattr(obs, name)
    assert obs.health.verdict()["status"] == "OK"
