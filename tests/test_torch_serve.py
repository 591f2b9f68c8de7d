"""The port's serving plane (`dbcsr_tpu_torch/serve/`, `obs/server.py`),
held against the JAX package's on the CPU.

* Coalescing: N same-pattern tenant products run as one block-diagonal
  composite equal the serialized run bit for bit -- on K1's plain
  version per span and fused, and on K3's under a forced
  ``pallas_cross`` -- and agree with the JAX engine's serialized run of
  the same operands (f64 and c8 within 1e-11 of max |C|, f32 and c4 at
  `kernel_validation_tolerance`).  The composite pays one set of
  dispatches, and the per-request flop shares sum to its flops.
* The admission state machine (OK admits, DEGRADED queues with a
  deadline, CRITICAL sheds with the structured rejection), quotas,
  deadlines and expiry, session isolation.
* The product cache: a hit runs no kernel, a changed value or an
  in-place write misses, the byte and entry budgets hold, and a cached
  C is copy-on-write against writes in place.
* ABFT per request: a served NaN is caught, the request re-executes and
  C is bit for bit the clean C.
* The write-ahead journal and `replay_journal` (exactly once).
* The HTTP routes on localhost, against the JAX server's payload keys.

Both packages' engines, sessions, product caches, metrics, events,
health models and telemetry stores are reset around each test.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dbcsr_tpu import serve as jax_serve
from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import server as jax_server
from dbcsr_tpu.obs import timeseries as jax_timeseries
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.serve import product_cache as jax_pcache
from dbcsr_tpu.serve import session as jax_session

from dbcsr_tpu_torch import serve
from dbcsr_tpu_torch.acc import crosspack_kernel, stack_kernel
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.obs import events, health, metrics, server, timeseries
from dbcsr_tpu_torch.obs.costmodel import kernel_validation_tolerance
from dbcsr_tpu_torch.ops import operations as pops
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.resilience import breaker, faults
from dbcsr_tpu_torch.serve import coalesce, engine as port_engine, product_cache
from dbcsr_tpu_torch.serve import session as port_session
from dbcsr_tpu_torch.serve.queue import Rejected

BS = [5, 3, 4, 5, 2, 5]
SERVE_FIELDS = ("serve_queue_max", "serve_window_ms", "serve_coalesce", "serve_coalesce_max",
                "serve_tenant_inflight", "serve_tenant_bytes", "serve_degraded_deadline_s",
                "serve_product_cache", "serve_product_cache_entries",
                "serve_product_cache_bytes")
PORT_FIELDS = SERVE_FIELDS + ("mm_driver", "superstack", "abft", "incremental")


_LIVE: list = []


def _live(eng):
    """An engine the test starts, shut down when it ends."""
    _LIVE.append(eng)
    return eng


def _reset_both():
    while _LIVE:
        _LIVE.pop().shutdown(drain=False)
    for eng in (serve, jax_serve):
        eng.shutdown()
    for mod in (port_session, jax_session):
        for s in list(mod.sessions().values()):
            s.close()
    for pc in (product_cache, jax_pcache):
        pc.clear()
    faults.clear()
    breaker.reset_board()
    for mod in (metrics, jax_metrics):
        mod.reset()
    for mod in (events, jax_events):
        mod.clear()
    for mod in (health, jax_health, timeseries, jax_timeseries):
        mod.reset()
    mm.clear_plan_cache()
    stack_kernel.reset_counts()
    crosspack_kernel.reset_counts()


@pytest.fixture(autouse=True)
def clean_both():
    pcfg = {k: getattr(get_config(), k) for k in PORT_FIELDS}
    jcfg = {k: getattr(jax_get_config(), k) for k in SERVE_FIELDS + ("mm_driver", "incremental")}
    for mod in (events, jax_events):
        mod.set_enabled(True)
    _reset_both()
    set_config(incremental="off")
    jax_set_config(mm_driver="xla", incremental="off")
    yield
    _reset_both()
    set_config(**pcfg)
    jax_set_config(**jcfg)
    for s in (server, jax_server):
        s.stop()


# ------------------------------------------------------------- operands
def _seeds(tenant: int, pattern_seed: int = 7):
    return [(pattern_seed, 0.5, 1.0 + tenant), (pattern_seed + 1, 0.6, 2.0 - 0.3 * tenant),
            (pattern_seed + 2, 0.3, 0.5 + 0.1 * tenant)]


def port_inputs(tenant: int, dtype=torch.float64, pattern_seed: int = 7):
    """Same pattern for every tenant, tenant-specific values (the JAX
    package's `tests/test_serve.py` operands)."""
    out = []
    for name, (seed, occ, scale) in zip("ABC", _seeds(tenant, pattern_seed)):
        m = port_tm.make_random_matrix(name, BS, BS, dtype=dtype, occupation=occ,
                                       rng=np.random.default_rng(seed), device="cpu")
        m.map_bin_data(lambda d, s=scale: d * s)
        out.append(m)
    return out


def jax_inputs(tenant: int, dtype=np.float64, pattern_seed: int = 7):
    out = []
    for name, (seed, occ, scale) in zip("ABC", _seeds(tenant, pattern_seed)):
        m = jax_tm.make_random_matrix(name, BS, BS, dtype=dtype, occupation=occ,
                                      rng=np.random.default_rng(seed))
        m.map_bin_data(lambda d, s=scale: d * s)
        out.append(m)
    return out


def run_port(coalesce_on: bool, n: int = 3, beta=0.5, dtype=torch.float64):
    """n tenants' requests queued while the engine is stopped, so starting
    it gathers them into one window; returns the C denses and results."""
    set_config(serve_coalesce=coalesce_on, serve_window_ms=100.0)
    eng = _live(serve.ServeEngine(start=False, device="cpu"))
    reqs = []
    for i in range(n):
        s = eng.open_session(f"tenant{i}")
        a, b, c = port_inputs(i, dtype)
        s.put("A", a), s.put("B", b), s.put("C", c)
        reqs.append((s, eng.submit(s, a="A", b="B", c="C", alpha=1.0, beta=beta), c))
    for _, r, _ in reqs:
        assert r.state == "queued", r.info()
    eng.start()
    for _, r, _ in reqs:
        assert r.wait(120) and r.state == "done", r.info()
    out = ([port_tm.to_dense(c) for _, _, c in reqs],
           [dict(r.result, phases_ms=r.info()["attribution"]["phases_ms"]) for _, r, _ in reqs])
    eng.shutdown()
    for s, _, _ in reqs:
        s.close()
    return out


def run_jax(n: int = 3, beta=0.5, dtype=np.float64):
    jax_set_config(serve_coalesce=False)
    eng = _live(jax_serve.ServeEngine(start=True))
    dens = []
    for i in range(n):
        s = eng.open_session(f"tenant{i}")
        a, b, c = jax_inputs(i, dtype)
        s.put("A", a), s.put("B", b), s.put("C", c)
        r = eng.submit(s, a="A", b="B", c="C", alpha=1.0, beta=beta)
        assert r.wait(120) and r.state == "done", r.info()
        dens.append(np.asarray(jax_tm.to_dense(c)))
        s.close()
    eng.shutdown()
    return dens


def _close(port, ref, dtype):
    scale = max(float(np.abs(ref).max()), 1e-30)
    name = {torch.float64: "float64", torch.float32: "float32", torch.complex128: "complex128",
            torch.complex64: "complex64"}[dtype]
    tol = 1e-11 if dtype in (torch.float64, torch.complex128) \
        else kernel_validation_tolerance(name, 5, 4)
    assert float(np.abs(port - ref).max()) <= tol * scale


# ------------------------------------------------------------ coalescing
@pytest.mark.parametrize("driver,superstack", [
    ("auto", "per_span"), ("auto", "fused"), ("pallas_cross", "per_span")])
def test_coalesced_bit_for_bit_serialized_and_jax(driver, superstack):
    """K1's plain version per span and fused, and K3's: the composite's
    C blocks are each request's, bit for bit."""
    set_config(mm_driver=driver, superstack=superstack)
    d_ser, res_ser = run_port(False)
    assert all(r["coalesced"] == 0 for r in res_ser)
    stack_kernel.reset_counts()
    crosspack_kernel.reset_counts()
    d_co, res_co = run_port(True)
    assert all(r["coalesced"] == 3 for r in res_co)
    if driver == "pallas_cross":
        assert crosspack_kernel.plain_calls > 0
    else:
        assert stack_kernel.plain_calls > 0
    for x, y in zip(d_ser, d_co):
        assert np.array_equal(x, y)
    modes = [(e["mode"], e["n"]) for e in events.records(kind="serve_execute")]
    assert ("coalesced", 3) in modes
    for p, j in zip(d_co, run_jax()):
        _close(p, j, torch.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128, torch.complex64])
def test_coalesced_other_kinds_against_jax(dtype):
    npdt = {torch.float32: np.float32, torch.complex128: np.complex128,
            torch.complex64: np.complex64}[dtype]
    d_ser, _ = run_port(False, dtype=dtype)
    d_co, res = run_port(True, dtype=dtype)
    assert all(r["coalesced"] == 3 for r in res)
    for x, y in zip(d_ser, d_co):
        assert np.array_equal(x, y)
    for p, j in zip(d_co, run_jax(dtype=npdt)):
        _close(p, j, dtype)


def test_coalescing_reduces_dispatches_and_shares_sum():
    def dispatches():
        return sum(v for _, v in metrics.counter_items("dbcsr_tpu_dispatches_total"))

    d0 = dispatches()
    _, res_ser = run_port(False, n=4, beta=0.0)
    ser = dispatches() - d0
    d1 = dispatches()
    _, res_co = run_port(True, n=4, beta=0.0)
    co = dispatches() - d1
    assert co * 4 == ser
    # the shares sum exactly to the composite's flops, as even as possible
    flops = [r["flops"] for r in res_co]
    assert max(flops) - min(flops) <= 1
    assert sum(flops) == sum(r["flops"] for r in res_ser)
    # each member's attribution row holds the group's host phases
    for r in res_co:
        assert set(r["phases_ms"]) >= {"compose", "index", "assemble", "plan", "launch",
                                       "carve", "execute"}


def test_flop_shares_sum_exactly_with_remainder():
    class R:
        def __init__(self, params):
            self.params = params
            self.request_id = "r"

    a, b, c = port_inputs(0)
    reqs = [R({"a": a, "b": b, "c": c.copy()}) for _ in range(3)]
    ref = c.copy()
    total = mm.multiply("N", "N", 1.0, a, b, 0.0, ref) * 3
    shares = coalesce.execute_coalesced(reqs)
    assert sum(shares) == total and max(shares) - min(shares) <= 1


def test_mixed_patterns_and_options_do_not_coalesce():
    set_config(serve_coalesce=True, serve_window_ms=20.0)
    eng = _live(serve.ServeEngine(start=False, device="cpu"))
    reqs = []
    for i in range(3):
        s = eng.open_session(f"tenant{i}")
        a, b, c = port_inputs(i, pattern_seed=20 + i)
        ref = c.copy()
        mm.multiply("N", "N", 1.0, a, b, 0.5, ref)
        s.put("A", a), s.put("B", b), s.put("C", c)
        reqs.append((eng.submit(s, a="A", b="B", c="C", beta=0.5), c, ref))
    a, b, c = port_inputs(0)
    s = eng.open_session("filtered")
    s.put("A", a), s.put("B", b), s.put("C", c)
    reqs.append((eng.submit(s, a="A", b="B", c="C", filter_eps=1e-3), c, None))
    assert reqs[-1][0].ckey is None
    eng.start()
    for r, c, ref in reqs:
        assert r.wait(60) and r.state == "done" and r.result["coalesced"] == 0
        if ref is not None:
            assert np.array_equal(port_tm.to_dense(c), port_tm.to_dense(ref))
    eng.shutdown()


def test_coalesced_failure_degrades_to_serialized_bit_for_bit():
    d_ser, _ = run_port(False)
    faults.clear()
    faults.configure("serve_execute:raise,times=1")
    d_deg, res = run_port(True)
    assert all(r["coalesced"] == 0 for r in res)
    assert events.records(kind="serve_degrade")
    for x, y in zip(d_ser, d_deg):
        assert np.array_equal(x, y)


def test_session_device_must_match_engine():
    eng = _live(serve.ServeEngine(start=False, device="cpu"))
    s = eng.open_session("t")
    assert s.device.type == "cpu"
    a, _, _ = port_inputs(0)
    s.put("A", a)
    with pytest.raises(ValueError, match="unknown serve op"):
        eng.submit(s, op="nope", a="A")
    with pytest.raises(KeyError):
        eng.submit(s, a="A", b="missing", c="A")


# ------------------------------------------------------------- admission
@pytest.mark.parametrize("status", ["OK", "DEGRADED", "CRITICAL"])
def test_admission_follows_health(monkeypatch, status):
    monkeypatch.setattr(health, "admission_status", lambda: status)
    set_config(serve_degraded_deadline_s=7.0)
    eng = _live(serve.ServeEngine(start=False, device="cpu"))
    s = eng.open_session("t")
    a, b, c = port_inputs(0)
    s.put("A", a), s.put("B", b), s.put("C", c)
    r = eng.submit(s, a="A", b="B", c="C")
    if status == "CRITICAL":
        assert r.state == "shed" and r.outcome == "WEDGED" and "critical" in r.error
        shed = dict((lab["reason"], v) for lab, v in
                    metrics.counter_items("dbcsr_tpu_serve_shed_total"))
        assert shed == {"critical": 1}
    else:
        assert r.state == "queued"
        if status == "DEGRADED":
            assert r.t_deadline == pytest.approx(r.t_submit + 7.0, abs=0.5)
        else:
            assert r.t_deadline is None
        eng.start()
        assert r.wait(60) and r.state == "done" and r.outcome == "OK"
    eng.shutdown()


def test_admit_fault_sheds_with_structured_rejection():
    faults.configure("serve_admit:raise,times=1")
    eng = _live(serve.ServeEngine(start=False, device="cpu"))
    s = eng.open_session("t")
    a, b, c = port_inputs(0)
    s.put("A", a), s.put("B", b), s.put("C", c)
    r = eng.submit(s, a="A", b="B", c="C")
    assert r.state == "shed" and r.error.startswith("shed: fault")
    faults.configure("serve_admit:raise,times=1")
    with pytest.raises(Rejected) as exc:
        eng.queue.admit(serve.Request(s, "multiply", {}))
    assert exc.value.reason == "fault"
    rec = events.records(kind="serve_shed")
    assert rec and rec[0]["tenant"] == "t"


@pytest.mark.parametrize("quota", ["queue_full", "quota_inflight", "quota_bytes"])
def test_quotas_shed(quota):
    a, b, c = port_inputs(0)
    nbytes = sum(port_session.matrix_nbytes(m) for m in (a, b, c))
    if quota == "queue_full":
        set_config(serve_queue_max=2)
    elif quota == "quota_inflight":
        set_config(serve_tenant_inflight=2)
    else:
        set_config(serve_tenant_bytes=2 * nbytes)
    eng = _live(serve.ServeEngine(start=False, device="cpu"))
    s = eng.open_session("t")
    s.put("A", a), s.put("B", b), s.put("C", c)
    states = [eng.submit(s, a="A", b="B", c="C").state for _ in range(3)]
    assert states == ["queued", "queued", "shed"]
    assert eng.tenants()["t"]["shed_by_reason"] == {quota: 1}
    eng.shutdown(drain=False)


def test_queued_deadline_expires_wedged_and_late_finish_is_slow():
    eng = _live(serve.ServeEngine(start=False, device="cpu"))
    s = eng.open_session("t")
    a, b, c = port_inputs(0)
    s.put("A", a), s.put("B", b), s.put("C", c)
    r = eng.submit(s, a="A", b="B", c="C", deadline_s=0.0)
    eng.start()
    assert r.wait(30) and r.state == "deadline_missed" and r.outcome == "WEDGED"
    r2 = eng.submit(s, a="A", b="B", c="C", deadline_s=60.0)
    assert r2.wait(60) and r2.outcome == "OK"
    r2.t_deadline = r2.t_submit - 1
    assert serve.queue.classify(r2) == "SLOW"
    eng.shutdown()


def test_sessions_are_isolated_and_close_frees():
    eng = _live(serve.ServeEngine(start=False, device="cpu"))
    s1, s2 = eng.open_session("t1"), eng.open_session("t2")
    m = s1.random("X", BS, BS, occupation=0.5, seed=3)
    assert s1.bytes_held() > 0 and s2.bytes_held() == 0
    with pytest.raises(KeyError):
        s2.get("X")
    assert serve.get_session(s1.session_id) is s1
    s1.close()
    assert not m.valid and serve.get_session(s1.session_id) is None
    with pytest.raises(RuntimeError, match="closed"):
        s1.create("Y", BS, BS)
    # the same draw as the JAX package's session
    js = jax_serve.Session("t1", register=False)
    jm = js.random("X", BS, BS, occupation=0.5, seed=3)
    pm = s2.random("X", BS, BS, occupation=0.5, seed=3)
    assert np.array_equal(np.asarray(jax_tm.to_dense(jm)), port_tm.to_dense(pm))


# ----------------------------------------------------------- product cache
def _cache_engine():
    set_config(serve_coalesce=False)
    eng = _live(serve.ServeEngine(start=True, device="cpu"))
    s = eng.open_session("t")
    a, b, _ = port_inputs(0)
    s.put("A", a), s.put("B", b)
    s.create("C1", BS, BS), s.create("C2", BS, BS), s.create("C3", BS, BS)
    return eng, s, a


def _submit_wait(eng, s, c):
    r = eng.submit(s, a="A", b="B", c=c)
    assert r.wait(60) and r.state == "done", r.info()
    return r


def _calls():
    return stack_kernel.plain_calls + crosspack_kernel.plain_calls + stack_kernel.launches


def test_product_cache_hit_runs_no_kernel():
    eng, s, _ = _cache_engine()
    r1 = _submit_wait(eng, s, "C1")
    n0 = _calls()
    r2 = _submit_wait(eng, s, "C2")
    assert _calls() == n0
    assert r2.result["cached"] == 1 and r2.result["saved_flops"] == r1.result["flops"]
    assert np.array_equal(port_tm.to_dense(s.get("C1")), port_tm.to_dense(s.get("C2")))
    hits = dict((lab["result"], v) for lab, v in
                metrics.counter_items("dbcsr_tpu_product_cache_total") if lab["tenant"] == "t")
    assert hits["hit"] == 1 and hits["store"] == 1
    eng.shutdown()


@pytest.mark.parametrize("how", ["in_place", "new_values"])
def test_product_cache_misses_on_changed_operand(how):
    eng, s, a = _cache_engine()
    _submit_wait(eng, s, "C1")
    if how == "in_place":
        a.bins[0].data.mul_(2.0)
    else:
        pops.scale(a, 2.0)
    n0 = _calls()
    r = _submit_wait(eng, s, "C2")
    assert "cached" not in r.result and _calls() > n0
    ref = port_tm.to_dense(s.get("C1")).copy()
    c3 = s.get("C3")
    mm.multiply("N", "N", 1.0, a, s.get("B"), 0.0, c3)
    assert np.array_equal(port_tm.to_dense(s.get("C2")), port_tm.to_dense(c3))
    assert not np.array_equal(port_tm.to_dense(s.get("C2")), ref)
    eng.shutdown()


def test_cached_c_is_copy_on_write():
    """A tenant writing its C in place after a hit never reaches the
    cached entry, nor the C it was first stored from."""
    eng, s, _ = _cache_engine()
    _submit_wait(eng, s, "C1")
    ref = port_tm.to_dense(s.get("C1")).copy()
    _submit_wait(eng, s, "C2")
    pops.scale(s.get("C2"), 3.0)
    s.get("C1").map_bin_data(lambda d: d.add_(1.0))
    assert np.array_equal(port_tm.to_dense(s.get("C2")), 3.0 * ref)
    r = _submit_wait(eng, s, "C3")
    assert r.result["cached"] == 1
    assert np.array_equal(port_tm.to_dense(s.get("C3")), ref)
    # a write that bypasses own_bins condemns the entry instead
    s.get("C3").bins[0].data.zero_()
    n0 = _calls()
    r = _submit_wait(eng, s, "C2")
    assert "cached" not in r.result and _calls() > n0
    assert np.array_equal(port_tm.to_dense(s.get("C2")), ref)
    eng.shutdown()


def test_product_cache_budgets():
    eng, s, _ = _cache_engine()
    set_config(serve_product_cache_bytes=8)
    _submit_wait(eng, s, "C1")
    assert product_cache.snapshot()["entries"] == 0  # larger than the budget
    set_config(serve_product_cache_bytes=1 << 30, serve_product_cache_entries=1)
    _submit_wait(eng, s, "C1")
    b2 = s.random("B2", BS, BS, occupation=0.6, seed=99)
    assert b2.valid
    r = eng.submit(s, a="A", b="B2", c="C2")
    assert r.wait(60) and r.state == "done"
    snap = product_cache.snapshot()
    assert snap["entries"] == 1 and snap["bytes"] == snap["bytes_by_tenant"]["t"] > 0
    evicted = [v for lab, v in metrics.counter_items("dbcsr_tpu_product_cache_total")
               if lab["result"] == "evict"]
    assert evicted == [1]
    eng.shutdown()


def test_product_cache_wire_round_trip():
    eng, s, _ = _cache_engine()
    _submit_wait(eng, s, "C1")
    (key,) = list(product_cache._entries)
    payload = product_cache.export_entry(product_cache.digest_of_key(key))
    ent = product_cache.entry_from_wire(json.loads(json.dumps(payload)), "cpu")
    c = s.get("C3")
    product_cache.install(ent, c)
    assert np.array_equal(port_tm.to_dense(c), port_tm.to_dense(s.get("C1")))
    eng.shutdown()


# ------------------------------------------------------------------- ABFT
def test_abft_per_request_catches_and_recovers():
    set_config(serve_coalesce=False, serve_product_cache=False)
    d_clean, _ = run_port(False)
    set_config(abft="verify")
    faults.configure("serve_execute:nan,times=1")
    d_rec, res = run_port(False)
    assert all(r.get("verified") == 1 for r in res)
    for x, y in zip(d_clean, d_rec):
        assert np.array_equal(x, y)
    mism = sum(v for _, v in metrics.counter_items("dbcsr_tpu_abft_mismatches_total"))
    recs = sum(v for lab, v in metrics.counter_items("dbcsr_tpu_abft_recoveries_total")
               if lab.get("driver") == "serve")
    assert mism >= 1 and recs == 1


# ---------------------------------------------------------------- journal
def test_drain_journal_and_replay_exactly_once(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    eng = _live(serve.ServeEngine(start=False, device="cpu"))
    s = eng.open_session("t", name="sess-1")
    a, b, c = port_inputs(0)
    s.put("A", a), s.put("B", b), s.put("C", c)
    tickets = [eng.submit(s, a="A", b="B", c="C", beta=0.0, request_id=f"r{i}")
               for i in range(2)]
    out = eng.drain(timeout=5.0, journal_path=path)
    assert out["journaled"] == 2 and all(t.state == "journaled" for t in tickets)
    assert eng.submit(s, a="A", b="B", c="C").error.startswith("shed: draining")
    eng2 = _live(serve.ServeEngine(start=True, device="cpu"))
    replayed = eng2.replay_journal(path)
    assert [t.request_id for t in replayed] == ["r0", "r1"]
    for t in replayed:
        assert t.wait(60) and t.state == "done"
    assert eng2.replay_journal(path) == []  # exactly once
    assert not os.path.exists(path)  # every line tombstoned: retired
    sub, done = port_engine.journal_ids(path)
    assert sub == done == set()
    eng2.shutdown()


def test_write_ahead_journal_tombstones(tmp_path, monkeypatch):
    path = str(tmp_path / "wal.jsonl")
    monkeypatch.setenv("DBCSR_TPU_TORCH_SERVE_JOURNAL", path)
    monkeypatch.setenv("DBCSR_TPU_TORCH_SERVE_WAL", "1")
    eng = _live(serve.ServeEngine(start=False, device="cpu"))
    s = eng.open_session("t", name="sess-w")
    a, b, c = port_inputs(0)
    s.put("A", a), s.put("B", b), s.put("C", c)
    r = eng.submit(s, a="A", b="B", c="C", request_id="w1")
    sub, done = port_engine.journal_ids(path)
    assert sub == {"w1"} and done == set()
    eng.start()
    assert r.wait(60) and r.state == "done"
    assert not os.path.exists(path)  # the tombstone retired the file
    eng.shutdown()


# ------------------------------------------------------------------- HTTP
def _call(url, route, body=None, timeout=30.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + route, data=data,
                                 headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read().decode()
            code = resp.status
    except urllib.error.HTTPError as exc:
        raw, code = exc.read().decode(), exc.code
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw


def _drive(url):
    """One tenant's session, operands by spec, a waited multiply, and the
    read routes; returns {route: (code, payload)}."""
    out = {}
    code, sess = _call(url, "/serve/session/open", {"tenant": "acme", "session_id": "s-acme"})
    out["open"] = (code, sess)
    for name, seed, occ in (("a", 1, 0.6), ("b", 2, 0.6)):
        out["matrix"] = _call(url, "/serve/matrix", {"session": "s-acme", "name": name,
                                                     "row_blk": BS, "occupation": occ,
                                                     "seed": seed})
    _call(url, "/serve/matrix", {"session": "s-acme", "name": "c", "row_blk": BS,
                                 "kind": "create"})
    out["submit"] = _call(url, "/serve/submit", {"session": "s-acme", "a": "a", "b": "b",
                                                 "c": "c", "wait": True, "timeout_s": 60})
    for route in ("/serve/status", "/serve/tenants", "/healthz", "/usage",
                  "/serve/checksum?session=s-acme&name=c", "/serve/heartbeat", "/",
                  "/slo", "/rca", "/timeseries", "/cluster?format=json",
                  "/tune/promotions?kind=cpu", "/profile/diff", "/events?limit=3", "/flight"):
        out[route] = _call(url, route)
    out["/metrics"] = _call(url, "/metrics")
    out["/serve/status?request_id"] = _call(
        url, f"/serve/status?request_id={out['submit'][1]['request_id']}")
    return out


def _keys(x):
    return set(x) if isinstance(x, dict) else type(x)


def test_http_routes_against_the_jax_server():
    set_config(serve_coalesce=False)
    jax_set_config(serve_coalesce=False)
    serve.get_engine(device="cpu")
    jax_serve.get_engine()
    port = _drive(server.start(0) and server.url())
    jax = _drive(jax_server.start(0) and jax_server.url())
    assert port["submit"][0] == 200 and port["submit"][1]["state"] == "done"
    for route in ("open", "matrix", "submit", "/serve/status", "/healthz", "/usage",
                  "/serve/checksum?session=s-acme&name=c", "/serve/heartbeat", "/slo",
                  "/rca", "/serve/status?request_id", "/cluster?format=json",
                  "/tune/promotions?kind=cpu", "/profile/diff", "/events?limit=3", "/flight"):
        assert port[route][0] == jax[route][0], route
        assert _keys(port[route][1]) == _keys(jax[route][1]), route
    assert port["/"][1]["routes"] == jax["/"][1]["routes"]
    assert set(port["/serve/tenants"][1]["acme"]) == set(jax["/serve/tenants"][1]["acme"])
    # the checksum the route reports is the in-process one, and the JAX one
    ck = port["/serve/checksum?session=s-acme&name=c"][1]["checksum"]
    assert ck == port_tm.checksum(port_session.get_session("s-acme").get("c"))
    assert ck == pytest.approx(jax["/serve/checksum?session=s-acme&name=c"][1]["checksum"],
                               rel=1e-12)
    assert "dbcsr_tpu_serve_requests_total" in port["/metrics"][1]
    # a shed comes back 429 with the structured rejection
    faults.configure("serve_admit:raise,times=1")
    code, info = _call(server.url(), "/serve/submit",
                       {"session": "s-acme", "a": "a", "b": "b", "c": "c"})
    assert code == 429 and info["state"] == "shed" and "fault" in info["error"]
    # a second open of the same id by another tenant is refused
    assert _call(server.url(), "/serve/session/open",
                 {"tenant": "other", "session_id": "s-acme"})[0] == 409


def test_http_serve_routes_need_an_engine():
    url = server.start(0) and server.url()
    assert _call(url, "/serve/status")[0] == 503
    hb = _call(url, "/serve/heartbeat")
    assert hb[0] == 200 and hb[1]["engine"] is False
    assert _call(url, "/nope")[0] == 404
    assert _call(url, "/serve/cache?digest=00")[0] == 404


def test_cluster_world_size_and_the_obs_seams(monkeypatch):
    """/cluster counts the processes of a `torch.distributed` world (none:
    this process alone), and the store's collectors, the serve SLOs and
    the ``fleet`` health component read the serving plane."""
    from dbcsr_tpu_torch.obs import slo
    from dbcsr_tpu_torch.serve.router import FleetRouter

    server.start(0)
    base = server.get().port
    assert server._world_size() is None
    assert server._cluster_peers() == [(0, f"http://127.0.0.1:{base}")]
    monkeypatch.setattr(server, "_world_size", lambda: 3)
    assert [p for _, p in server._cluster_peers()] == \
        [f"http://127.0.0.1:{base + i}" for i in range(3)]
    eng = serve.get_engine(device="cpu")  # the collectors read the process's engine
    s = eng.open_session("t")
    a, b, _ = port_inputs(0)
    s.put("A", a), s.put("B", b), s.create("C1", BS, BS), s.create("C2", BS, BS)
    _submit_wait(eng, s, "C1")
    _submit_wait(eng, s, "C2")
    names = {p[0] for p in timeseries._collect_serve()}
    assert {"dbcsr_tpu_serve_queue_depth", "dbcsr_tpu_serve_latency_p95_ms",
            "dbcsr_tpu_serve_requests_total"} <= names
    assert "dbcsr_tpu_product_cache_bytes" in {p[0] for p in timeseries._collect_value_reuse()}
    assert "dbcsr_tpu_workload_sink_active" in {p[0] for p in timeseries._collect_workload()}
    timeseries.sample()
    got = {r["metric"] for r in timeseries.query("dbcsr_tpu_serve_latency_p95_ms")}
    assert got == {"dbcsr_tpu_serve_latency_p95_ms"}
    # the serve objectives read those series (the store's SLO tests
    # drive their burn rates)
    assert {o.name for o in slo.objectives()} >= {"serve_p95_latency", "serve_errors"}
    FleetRouter([("w0", "http://127.0.0.1:9"), ("w1", "http://127.0.0.1:9")]).mark_down("w0")
    assert health.verdict()["components"]["fleet"]["status"] == "DEGRADED"
