"""The port's online tuner (dbcsr_tpu_torch.tune) held against the JAX
package's (dbcsr_tpu.tune) on the CPU.

Parity on the same inputs: the miner's ranking on the same telemetry
points and capture rows, the predictor's transfer and ridge
coefficients, the store's promote/demote ledger, `select_winner` past
an open breaker, a faulted trial promoting nothing, and the trial's
stack clamp.  The port's own decisions: only this device's capture rows
and only device-second rates are mined, the transfer reads only the
port's parameter directory, a promotion bumps the generation so the
next multiply misses the plan cache and runs the promoted row, the
format planner takes a donor row (`format_prior`), the peer-sync client
against a stub HTTP server on localhost, and synchronous CPU cycles end
to end (kernel axis, format axis, faulted).

Every table is written under ``tmp_path`` (both packages' parameter
directories point there); every test resets both packages' tuner
services, health, telemetry, SLO, change-point, RCA and incident state,
faults, breakers, metrics and events.
"""

import http.server
import json
import os
import threading

import numpy as np
import pytest

from dbcsr_tpu.acc import params as jax_params
from dbcsr_tpu.obs import changepoint as jax_cp
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import incidents as jax_incidents
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import rca as jax_rca
from dbcsr_tpu.obs import slo as jax_slo
from dbcsr_tpu.obs import timeseries as jax_ts
from dbcsr_tpu.resilience import breaker as jax_breaker
from dbcsr_tpu.resilience import faults as jax_faults
from dbcsr_tpu.tune import miner as jax_miner
from dbcsr_tpu.tune import predictor as jax_predictor
from dbcsr_tpu.tune import service as jax_service
from dbcsr_tpu.tune import store as jax_store
from dbcsr_tpu.tune import trials as jax_trials

from dbcsr_tpu_torch import device as port_device
from dbcsr_tpu_torch.acc import params
from dbcsr_tpu_torch.acc import smm as port_smm
from dbcsr_tpu_torch.core import stats
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.matrix import create
from dbcsr_tpu_torch.mm import format_planner
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.obs import changepoint, costmodel, events, health, incidents, metrics
from dbcsr_tpu_torch.obs import rca, slo
from dbcsr_tpu_torch.obs import timeseries as ts
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.resilience import breaker, faults
from dbcsr_tpu_torch.tune import miner, predictor, store, trials
from dbcsr_tpu_torch.tune import service as tune_service

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(ROOT, "dbcsr_tpu_torch", "acc", "params",
                         "parameters_NVIDIA_H100_80GB_HBM3.json")
_CFG = ("mm_format", "mm_driver", "incremental", "mm_stack_size")


def _reset_both() -> None:
    for f in (faults, jax_faults):
        f.clear()
    for b in (breaker, jax_breaker):
        b.reset_board()
    for m in (metrics, jax_metrics):
        m.reset()
    for mod in (events, jax_events):
        mod.clear()
    for mod in (health, jax_health, ts, jax_ts, slo, jax_slo, changepoint, jax_cp,
                rca, jax_rca, incidents, jax_incidents):
        mod.reset()
    for svc in (tune_service, jax_service):
        svc.stop_service()
    for p in (params, jax_params):
        p.invalidate()
    port_smm._cross_disabled.clear()
    format_planner.reset()
    mm.clear_plan_cache()


@pytest.fixture(autouse=True)
def hermetic(tmp_path, monkeypatch):
    """Both packages' tables in empty directories under ``tmp_path``; the
    committed H100 table is never read or written."""
    with open(COMMITTED, "rb") as fh:
        committed = fh.read()
    monkeypatch.setenv("DBCSR_TPU_TORCH_PARAMS_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("DBCSR_TPU_PARAMS_DIR", str(tmp_path / "jax"))
    for name in ("DBCSR_TPU_TORCH_SYNC_TIMING", "DBCSR_TPU_TORCH_FLEET_PEERS",
                 "DBCSR_TPU_FLEET_PEERS", "DBCSR_TPU_TORCH_INCIDENTS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("DBCSR_TPU_INCIDENTS", "0")
    cfg = {k: getattr(get_config(), k) for k in _CFG}
    _reset_both()
    set_config(incremental="off")
    yield tmp_path
    set_config(**cfg)
    _reset_both()
    with open(COMMITTED, "rb") as fh:
        assert fh.read() == committed
    assert health.verdict()["status"] == "OK"
    assert jax_health.verdict()["status"] == "OK"


def _counter_total(mod, name, **labels) -> float:
    return sum(v for lb, v in mod.counter_items(name)
               if all(lb.get(k) == val for k, val in labels.items()))


def _fake_query(series):
    """A `timeseries.query`-shaped callable over canned series."""

    def query(metric=None, labels=None, since=None, until=None, agg=None, tier="auto",
              path=None):
        out = []
        for m, lb, pts in series:
            if metric is not None and m != metric:
                continue
            if labels and any(lb.get(k) != v for k, v in labels.items()):
                continue
            ent = {"metric": m, "labels": dict(lb), "kind": "gauge", "tier": "raw",
                   "points": [list(p) for p in pts]}
            if agg == "last":
                ent["value"] = pts[-1][1] if pts else None
            out.append(ent)
        return out

    return query


def _row(m, driver, gflops, **kw):
    return dict({"m": m, "n": m, "k": m, "dtype": "float64", "stack_size": 30000,
                 "driver": driver, "grouping": None, "gflops": gflops, "env": "cpu"}, **kw)


# ------------------------------------------------------------- miner
def _mine_series(seed):
    rng = np.random.default_rng(seed)
    series = []
    for mnk in ("8x8x8", "23x23x23", "5x13x23", "4x4x4"):
        for drv in ("pallas", "pallas_cross"):
            series.append(("dbcsr_tpu_cell_flops_total",
                           {"mnk": mnk, "driver": drv, "dtype": "float64"},
                           [[0.0, float(rng.integers(1, 10**12))]]))
    series += [("dbcsr_tpu_achieved_gflops", {"driver": "pallas"}, [[0.0, 0.5]]),
               ("dbcsr_tpu_roofline_fraction", {"driver": "pallas"}, [[0.0, 0.01]]),
               ("dbcsr_tpu_achieved_gflops", {"driver": "pallas_cross"}, [[0.0, 2.0]]),
               ("dbcsr_tpu_roofline_fraction", {"driver": "pallas_cross"},
                [[0.0, float(rng.random()) * 0.5]])]
    return series


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_miner_ranking_matches_jax(seed):
    series = _mine_series(seed)
    params.save_entry(_row(10, "pallas", 8.0))
    jax_params.save_entry(_row(10, "pallas", 8.0))
    got = miner.mine(query=_fake_query(series), capture_paths=[])
    want = jax_miner.mine(query=_fake_query(series), capture_paths=[])
    assert got == want and got
    assert [c["wasted_flop_seconds"] for c in got] == \
        sorted((c["wasted_flop_seconds"] for c in got), reverse=True)
    assert metrics._gauges["dbcsr_tpu_tune_queue_depth"].value() == len(got)


def test_miner_mines_only_this_devices_capture_rows(tmp_path):
    """Decision 6: rows of another device (the committed TPU rows) or of
    no device are never mined; rows of this device mine as in the JAX
    package."""
    kind = costmodel.device_kind()
    rows = [{"kernel": "23x23x23", "dtype": "float64", "stack_size": 100000, "gflops": 0.2,
             "modeled": {"roofline_fraction": 0.01}, "device": dev}
            for dev in (kind, f"{kind}0", "TPU v5 lite0", None)]
    rows[1]["kernel"] = "8x8x8"
    rows[2]["kernel"] = rows[3]["kernel"] = "16x16x16"
    cap = tmp_path / "captures.jsonl"
    cap.write_text("".join(json.dumps(r) + "\n" for r in rows) + "torn{line\n")
    got = miner.mine(query=_fake_query([]), capture_paths=[str(cap)])
    jcap = tmp_path / "jax_captures.jsonl"
    jcap.write_text("".join(json.dumps(r) + "\n" for r in rows[:2]))
    want = jax_miner.mine(query=_fake_query([]), capture_paths=[str(jcap)])
    assert [(c["m"], c["wasted_flop_seconds"]) for c in got] == \
        [(c["m"], c["wasted_flop_seconds"]) for c in want]
    assert sorted(c["m"] for c in got) == [8, 23]
    # the repo's own capture files hold TPU rows only: nothing to mine
    assert miner._mine_captures(miner._default_capture_paths()) == []


def test_miner_reads_device_rates_only(monkeypatch):
    """Decision 1: a rollup with no synchronized region is never mined;
    the same multiplies under synchronized timing are."""
    monkeypatch.setenv("DBCSR_TPU_TORCH_TS_INTERVAL_S", "0")
    monkeypatch.setenv("DBCSR_TPU_TORCH_TUNE_FLOOR", "1.0")
    rng = np.random.default_rng(0)
    a, b, c = (port_tm.make_random_matrix(n, [6] * 6, [6] * 6, occupation=0.6, rng=rng,
                                          device="cpu") for n in "ABC")
    set_config(mm_format="stack")
    mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    assert ts.query("dbcsr_tpu_cell_flops_total") and \
        not ts.query("dbcsr_tpu_roofline_fraction")
    assert miner.mine(capture_paths=[]) == []
    monkeypatch.setenv("DBCSR_TPU_TORCH_SYNC_TIMING", "1")
    mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    cells = miner.mine(capture_paths=[])
    assert cells and (cells[0]["m"], cells[0]["driver"]) == (6, "pallas")
    assert "floor 1.0" in cells[0]["reason"]


# ------------------------------------------------------------ trials
@pytest.mark.parametrize("shape,want,budget", [((23, 23, 23), 30000, 1 << 20),
                                               ((23, 23, 23), 30000, 1 << 30),
                                               ((64, 64, 64), 30000, 1024),
                                               ((4, 5, 6), 777, 1 << 16)])
def test_clamp_stack_size_matches_jax(shape, want, budget):
    for dt in ("float64", "float32"):
        assert trials.clamp_stack_size(*shape, dt, want, budget=budget) == \
            jax_trials.clamp_stack_size(*shape, dt, want, budget=budget)


def test_trial_fault_aborts_with_no_candidates():
    cell = dict(m=4, n=4, k=4, dtype="float64", stack_size=256)
    res = []
    for tr, fa in ((trials, faults), (jax_trials, jax_faults)):
        with fa.inject_faults("tune_trial:raise,times=1") as specs:
            res.append(tr.run_trial(cell, reps=1, **({"device": "cpu"} if tr is trials else {})))
        assert specs[0].fired == 1
    for r in res:
        assert r.outcome == "faulted" and not r.ok and r.candidates == [] and r.entry is None
    assert _counter_total(metrics, "dbcsr_tpu_tune_trials_total", outcome="faulted") == \
        _counter_total(jax_metrics, "dbcsr_tpu_tune_trials_total", outcome="faulted") == 1
    assert [e["outcome"] for e in events.records(kind="tune_trial")] == ["faulted"]
    for m in (metrics, jax_metrics):
        m.reset()
    for h in (health, jax_health):
        h.reset()


def test_cpu_trial_times_the_port_candidates(monkeypatch):
    out = trials.run_trial(dict(m=4, n=4, k=4, dtype="float64", stack_size=512), reps=1,
                           device="cpu")
    assert out.ok and out.stack_size == 512
    assert {c["driver"] for c in out.candidates} >= {"pallas", "torch"}
    assert all(c["max_rel_err"] <= c["tol"] for c in out.candidates)
    assert out.entry["env"] == "cpu"
    assert not os.path.exists(params.params_path())  # a trial persists nothing


def test_select_winner_skips_an_open_breaker_like_jax():
    key = (4, 4, 4, "float64")
    cands = [{"driver": "pallas", "grouping": None, "gflops": 99.0},
             {"driver": "torch", "grouping": None, "gflops": 1.0}]
    for br in (breaker, jax_breaker):
        board = br.get_board()
        for _ in range(board.fail_threshold):
            board.record_failure("pallas", key)
    for tr in (trials, jax_trials):
        assert tr.select_winner(cands, 4, 4, 4, np.float64)["driver"] == "torch"
        assert tr.select_winner(cands, 5, 5, 5, np.float64)["driver"] == "pallas"
    assert trials.select_winner(cands[:1], 4, 4, 4, "float64") is None
    breaker.reset_board()
    jax_breaker.reset_board()


# ------------------------------------------------------------- store
def _strip(rec):
    rec = json.loads(json.dumps(rec))
    for k in ("ts", "t_unix"):
        rec.pop(k, None)
    for key in ("entry", "demoted_entry"):
        if rec.get(key):
            rec[key].pop("tuned_by", None)
    return rec


def test_promote_demote_and_ledger_match_jax(monkeypatch):
    for st in (store, jax_store):
        monkeypatch.setattr(st, "_live_roofline", lambda driver: 0.5)
    recs = []
    for p, st in ((params, store), (jax_params, jax_store)):
        p.save_entry(_row(4, "torch", 0.1, stack_size=512))
        rec = st.promote(_row(4, "pallas", 3.0, stack_size=256), trial={"elapsed_s": 1.0},
                         stack_size=512)
        recs.append(_strip(rec))
        row = p.lookup(4, 4, 4, np.float64, stack_size=512)
        assert (row["driver"], row["trial_stack_size"]) == ("pallas", 256)
    assert recs[0] == recs[1]
    assert params.lookup(4, 4, 4, np.float64)["tuned_by"] == "dbcsr_tpu_torch.tune"
    now = __import__("time").time()
    collapsed = _fake_query([("dbcsr_tpu_roofline_fraction", {"driver": "pallas"},
                              [[now + 1.0 + t, 0.05] for t in range(6)])])
    stale = _fake_query([("dbcsr_tpu_roofline_fraction", {"driver": "pallas"},
                          [[now - 100.0 + t, 0.05] for t in range(6)])])
    short = _fake_query([("dbcsr_tpu_roofline_fraction", {"driver": "pallas"},
                          [[now + 1.0, 0.01], [now + 2.0, 0.01]])])
    for p, st in ((params, store), (jax_params, jax_store)):
        assert st.check_regressions(query=stale) == []
        assert st.check_regressions(query=short) == []
        gen = p.generation()
        assert st.check_regressions(query=collapsed) == [[4, 4, 4, "float64", 512]]
        assert p.generation() > gen
        assert p.lookup(4, 4, 4, np.float64, stack_size=512)["driver"] == "torch"
        assert st.live_promotions() == []
    assert [_strip(r) for r in store.load_ledger()] == [_strip(r) for r in jax_store.load_ledger()]
    assert [r["action"] for r in store.load_ledger()] == ["promote", "demote"]
    assert os.path.basename(store.ledger_path()) == "promotions_cpu.json"
    for lab in ("promotions", "demotions"):
        name = f"dbcsr_tpu_tune_{lab}_total"
        assert metrics.counter_items(name) == jax_metrics.counter_items(name)


def test_promotion_retires_cached_plans_and_runs_the_promoted_row():
    """A promotion bumps the generation: the next multiply misses the
    plan cache and dispatches the promoted driver."""
    from dbcsr_tpu_torch import native

    bs = [4] * 6
    a = port_tm.make_random_matrix("A", bs, bs, occupation=0.6,
                                   rng=np.random.default_rng(0), device="cpu")
    b = port_tm.make_random_matrix("B", bs, bs, occupation=0.6,
                                   rng=np.random.default_rng(1), device="cpu")
    c = create("C", bs, bs, device="cpu")
    set_config(mm_format="stack")
    params.save_entry(_row(4, "torch", 0.5, stack_size=512))
    for _ in range(2):
        mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    ref = c.to_dense() if hasattr(c, "to_dense") else None
    mm.reset_totals()
    mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    assert c._mm_plan_cache == "hit"
    gen0 = params.generation()
    host0 = stats.driver_rollup().get("host", {}).get("flops", 0)
    store.promote(_row(4, "host", 9.0, stack_size=512))
    assert params.generation() > gen0
    mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    assert c._mm_plan_cache == "miss"
    if native.host_smm_supports(np.float64):
        assert stats.driver_rollup()["host"]["flops"] > host0
    if ref is not None:
        np.testing.assert_allclose(np.asarray(c.to_dense()), np.asarray(ref), rtol=0,
                                   atol=1e-12)


# --------------------------------------------------------- predictor
def _kind_table(d, kind, rows):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"parameters_{kind}.json"), "w") as fh:
        json.dump(rows, fh)


def test_transfer_scales_by_peak_ratio_like_jax(hermetic, monkeypatch):
    donor = [_row(23, "pallas", 100.0, stack_size=100000, env="cuda")]
    peaks = {"cpu": 50.0, "donor kind": 200.0}
    for d, cm in ((hermetic / "port", costmodel), (hermetic / "jax", None)):
        _kind_table(str(d), "donor_kind", donor)
    monkeypatch.setattr(costmodel, "peak_gflops",
                        lambda kind=None, dtype="float64": peaks.get(kind.replace("_", " ")))
    from dbcsr_tpu.obs import costmodel as jax_costmodel

    monkeypatch.setattr(jax_costmodel, "peak_gflops",
                        lambda kind=None, dtype="float64": peaks.get(kind.replace("_", " ")))
    got = predictor.transfer_predict(23, 23, 23, np.float64, stack_size=100000)
    want = jax_predictor.transfer_predict(23, 23, 23, np.float64, stack_size=100000)
    assert got == want and got["gflops"] == 25.0 and got["transfer_from"] == "donor_kind"
    assert predictor.transfer_predict(256, 256, 256, np.float64) is None


def test_transfer_never_reads_the_jax_tables(monkeypatch):
    """Decision 6: the JAX package's TPU tables are not donors."""
    monkeypatch.delenv("DBCSR_TPU_TORCH_PARAMS_DIR")
    assert "TPU_v5_lite" not in predictor._kind_tables("cpu")
    assert set(predictor._kind_tables("cpu")) <= {"NVIDIA_H100_80GB_HBM3"}


def test_ridge_coefficients_and_evidence_ladder_match_jax():
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(24):
        m = int(rng.integers(4, 64))
        s = int(rng.integers(1000, 100000))
        rows.append(dict(_row(m, "pallas", 4.0 * (m / 23.0) ** 0.5), stack_size=s))
        rows.append(dict(_row(m, "torch", 0.4 * (m / 23.0) ** 0.5 * (1 + rng.random())),
                         stack_size=s, dtype="float32"))
    reg, jreg = predictor.TrialRegressor(), jax_predictor.TrialRegressor()
    assert reg.fit(rows) == jreg.fit(rows) == 48
    for drv, w in reg.weights.items():
        np.testing.assert_allclose(w, jreg.weights[drv], rtol=1e-12, atol=0)
    for cell in ((23, 23, 23, "float64", 30000), (5, 13, 23, "float32", 1000)):
        got, want = reg.predict_gflops(*cell), jreg.predict_gflops(*cell)
        for drv in want:
            assert got[drv] == pytest.approx(want[drv], rel=1e-12)
        assert reg.suggest(*cell) == jreg.suggest(*cell)
    assert predictor.lookup_extended(23, 23, 23, np.float64, stack_size=30000,
                                     regressor=reg)["predicted"] == "learned"
    params.save_entry(_row(23, "pallas_cross", 1.0))
    got = predictor.lookup_extended(23, 23, 23, np.float64, stack_size=30000, regressor=reg)
    assert got["driver"] == "pallas_cross" and "predicted" not in got
    assert predictor.training_rows() == [params.lookup(23, 23, 23, np.float64)]


def test_format_prior_and_the_planners_donor_row():
    for p in (params, jax_params):
        p.save_entry(_row(8, "pallas", 1.0, format="dense", format_occ=0.0))
    got = predictor.format_prior(6, 6, 6, np.float64)
    assert got == jax_predictor.format_prior(6, 6, 6, np.float64)
    assert got["format_from"] == [8, 8, 8]
    assert predictor.format_prior(6, 6, 6, np.float32) is None
    rng = np.random.default_rng(2)
    a, b = (port_tm.make_random_matrix(n, [6] * 4, [6] * 4, occupation=1.0, rng=rng,
                                       device="cpu") for n in "AB")
    c = create("C", [6] * 4, [6] * 4, device="cpu")
    mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    assert (c._mm_algorithm, mm.read_totals()["formats"]) == \
        ("dense", mm.read_totals()["formats"]) and \
        any(k.startswith("dense") and "tuned" in k for k in
            (f"{f}:{r}" for (f, r) in _decisions()))


def _decisions():
    return [(lb["format"], lb["reason"]) for lb, _ in
            metrics.counter_items("dbcsr_tpu_format_decision_total")]


# --------------------------------------------------------- peer sync
class _Peer(http.server.BaseHTTPRequestHandler):
    payload = {}

    def do_GET(self):
        if not self.path.startswith("/tune/promotions"):
            self.send_error(404)
            return
        body = json.dumps(self.payload).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def test_peer_sync_adopts_a_same_kind_peers_promotions():
    srv = http.server.HTTPServer(("127.0.0.1", 0), _Peer)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        _Peer.payload = {"kind": "cpu", "rows": [
            {"key": [4, 4, 4, "float64", 512], "generation": 3,
             "entry": _row(4, "pallas", 7.0, stack_size=512)},
            {"key": [5, 5, 5, "float64", 0], "entry": _row(5, "host", 1.0,
                                                             adopted_from="x")}]}
        gen = params.generation()
        assert store.peer_sync(peers=[url]) == [[4, 4, 4, "float64", 512]]
        assert params.generation() > gen
        row = params.lookup(4, 4, 4, np.float64)
        assert row["adopted_from"] == url and row["driver"] == "pallas"
        assert store.export_promotions()["rows"] == []  # adopted rows never re-export
        assert store.peer_sync(peers=[url]) == []  # as good already: no churn
        _Peer.payload = {"kind": "TPU_v5_lite", "rows": _Peer.payload["rows"]}
        assert store.peer_sync(peers=[url]) == []
        assert store.peer_sync(peers=[url + "/missing"]) == []
        got = {lb["event"]: v for lb, v in metrics.counter_items("dbcsr_tpu_tune_fleet_total")}
        assert got == {"adopted": 1.0, "kind_mismatch": 1.0, "peer_miss": 1.0}
    finally:
        srv.shutdown()
        srv.server_close()


# ----------------------------------------------------------- service
def test_cycle_defers_on_degraded_admission(monkeypatch):
    for svc_mod, h in ((tune_service, health), (jax_service, jax_health)):
        monkeypatch.setattr(h, "admission_status", lambda: "DEGRADED")
        svc = svc_mod.TuneService(interval_s=3600)
        out = svc.cycle(cells=[dict(m=4, n=4, k=4, dtype="float64", stack_size=256)])
        assert out["outcome"] == "deferred:DEGRADED" and svc.snapshot()["deferred"] == 1


def test_cpu_cycle_promotes_end_to_end(monkeypatch):
    monkeypatch.setenv("DBCSR_TPU_TORCH_TUNE_NREP", "1")
    monkeypatch.setenv("DBCSR_TPU_TORCH_TUNE_BUDGET_BYTES", str(1 << 20))
    params.save_entry(_row(4, "pallas_cross", 0.01, stack_size=512, pack_p=2))
    svc = tune_service.TuneService(interval_s=3600, device="cpu")
    cell = dict(m=4, n=4, k=4, dtype="float64", stack_size=512, observed_gflops=1e-4,
                target_gflops=10.0, wasted_flop_seconds=100.0)
    gen0 = params.generation()
    out = svc.cycle(cells=[cell])
    assert out["outcome"] == "promoted", out
    row = params.lookup(4, 4, 4, np.float64, stack_size=512)
    assert row["tuned_by"] == "dbcsr_tpu_torch.tune"
    assert row["gflops"] == out["promoted"]["gflops"] and row["driver"] != "pallas_cross"
    assert row["driver"] in ("pallas", "torch", "host")
    assert params.generation() > gen0 and out["promoted"]["generation"] == 1
    snap = svc.snapshot()
    assert (snap["promotions"], snap["trials"], snap["trial_failure_streak"]) == (1, 1, 0)
    assert [e["driver"] for e in events.records(kind="tune_promotion")] == [row["driver"]]


def test_faulted_cycle_promotes_nothing():
    svc = tune_service.TuneService(interval_s=3600, device="cpu")
    cell = dict(m=4, n=4, k=4, dtype="float64", stack_size=256, observed_gflops=0.01)
    gen0 = params.generation()
    with faults.inject_faults("tune_trial:raise,times=1"):
        out = svc.cycle(cells=[cell])
    assert out["outcome"] == "trial_faulted" and out["promoted"] is None
    assert store.live_promotions() == [] and params.generation() == gen0
    assert svc.snapshot()["trial_failure_streak"] == 1
    metrics.reset()
    health.reset()


def test_idle_cycle_runs_the_format_axis(monkeypatch):
    monkeypatch.setenv("DBCSR_TPU_TORCH_TUNE_NREP", "1")
    plan = format_planner.Plan("stack", "default", predicted={"stack": {"gflops": 10.0},
                                                             "dense": {"gflops": 50.0}},
                               cell=(6, 6, 6, "float64"), occ=0.95, grid=(4, 4, 4))
    format_planner.note_outcome(plan, seconds=1.0, flops=1e9)
    cells = miner.mine_format()
    assert [(c["m"], c["format"], c["driver"]) for c in cells] == [(6, "stack", "format")]
    svc = tune_service.TuneService(interval_s=3600, device="cpu")
    out = svc.cycle(cells=[])
    assert out["cell"]["format"] == "stack"
    trial = [e for e in events.records(kind="tune_trial") if e.get("axis") == "format"]
    assert trial and trial[0]["outcome"] == "ok" and trial[0]["candidates"] >= 2
    assert out["outcome"] in ("promoted", "held")
    if out["outcome"] == "promoted":
        row = params.lookup(6, 6, 6, np.float64)
        assert row["format"] in ("dense", "composite") and row["format_occ"] == 0.95


def test_obs_surfaces_see_the_live_service():
    svc = tune_service.get_service(device="cpu")
    comp = health.verdict()["components"]["tune"]
    assert (comp["status"], comp["running"]) == ("OK", False)
    names = {p[0] for p in ts._collect_tune()}
    assert {"dbcsr_tpu_params_generation", "dbcsr_tpu_tune_queue_depth"} <= names
    svc.stats["trial_failure_streak"] = 3
    assert health.verdict()["components"]["tune"]["status"] == "DEGRADED"
    assert health.admission_status() == "OK"
    svc.stats["trial_failure_streak"] = 0
    assert tune_service.current_service() is svc
    tune_service.stop_service()
    assert tune_service.current_service() is None
    assert tune_service.maybe_start_from_env() is None


def test_default_device_cycle_runs_on_the_cpu_when_asked():
    prev = port_device._default
    port_device.set_default_device("cpu")
    try:
        res = trials.run_trial(dict(m=3, n=3, k=3, dtype="float32", stack_size=256), reps=1)
    finally:
        port_device.set_default_device(prev)
    assert res.ok and res.entry["env"] == "cpu"


def test_format_trial_keeps_the_jax_grid_clamp(monkeypatch):
    """Decision 7: the trial's block grid is clamped to 2-16 block rows a
    dimension, as in the JAX package, whatever the mined cell's grid."""
    import dbcsr_tpu_torch

    seen = []
    real = dbcsr_tpu_torch.make_random_matrix

    def spy(name, rows, cols, **kw):
        seen.append((len(rows), len(cols)))
        return real(name, rows, cols, **kw)

    monkeypatch.setattr(dbcsr_tpu_torch, "make_random_matrix", spy)
    cell = {"m": 5, "n": 5, "k": 5, "dtype": "float64", "occ": 0.3, "grid": [435, 1, 20]}
    res = trials.run_format_trial(cell, reps=1, device="cpu")
    assert res.ok and seen == [(16, 16), (16, 2)]
    assert {c["format"] for c in res.candidates} >= {"stack", "dense"}
    assert res.entry["format"] in ("stack", "dense", "composite")

