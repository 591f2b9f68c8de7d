"""The port's workload plane (`dbcsr_tpu_torch/serve/workload.py`), held
against the JAX package's on the CPU.

* A trace the JAX engine records replays in the port: both packages
  read the same records, derive the same request stream from them
  (`request_stream` is a pure function of records and seed), and the
  port's replay gives the JAX replay's checksums (f64, within 1e-11
  relative) with the same product-cache hits.
* A trace the port records reads the same in the JAX package (stdlib
  JSON, dtype names and value digests only, no values).
* `fit` and `synthesize` agree with the JAX package's on the same
  records; the recorder is inert when off; the ``replay_submit`` fault
  site sheds before the engine.

Both packages' engines, sessions, product caches, sinks and metrics are
reset around each test.
"""

from __future__ import annotations

import json

import pytest

from dbcsr_tpu import serve as jax_serve
from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.serve import product_cache as jax_pcache
from dbcsr_tpu.serve import session as jax_session
from dbcsr_tpu.serve import workload as jax_wl

from dbcsr_tpu_torch import serve
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.obs import events, health, metrics, timeseries
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.resilience import faults
from dbcsr_tpu_torch.serve import product_cache
from dbcsr_tpu_torch.serve import session as port_session
from dbcsr_tpu_torch.serve import workload

BS = [4] * 5
FIELDS = ("serve_coalesce", "serve_window_ms", "incremental")


_LIVE: list = []


def _live(eng):
    """An engine the test starts, shut down when it ends."""
    _LIVE.append(eng)
    return eng


def _reset():
    while _LIVE:
        _LIVE.pop().shutdown()
    for wl in (workload, jax_wl):
        wl.disable_sink()
    for eng in (serve, jax_serve):
        eng.shutdown()
    for mod in (port_session, jax_session):
        for s in list(mod.sessions().values()):
            s.close()
    for pc in (product_cache, jax_pcache):
        pc.clear()
    for m in (metrics, jax_metrics):
        m.reset()
    for mod in (events, jax_events):
        mod.clear()
    for mod in (health, jax_health, timeseries, jax_timeseries):
        mod.reset()
    faults.clear()


@pytest.fixture(autouse=True)
def clean_both():
    pcfg = {k: getattr(get_config(), k) for k in FIELDS}
    jcfg = {k: getattr(jax_get_config(), k) for k in FIELDS + ("mm_driver",)}
    _reset()
    set_config(serve_coalesce=False, incremental="off")
    jax_set_config(serve_coalesce=False, incremental="off", mm_driver="xla")
    yield
    _reset()
    set_config(**pcfg)
    jax_set_config(**jcfg)


def _record(eng, wl, path, tenants=2, requests=4, distinct=2):
    """tenants x requests multiplies over ``distinct`` operand pairs per
    tenant, by name, recorded to ``path``."""
    wl.enable_sink(path)
    for t in range(tenants):
        s = eng.open_session(f"t{t}")
        for d in range(distinct):
            s.random(f"a{d}", BS, BS, occupation=0.6, seed=100 * t + d)
            s.random(f"b{d}", BS, BS, occupation=0.6, seed=100 * t + d + 50)
        for i in range(requests):
            d = i % distinct
            s.create(f"c{i}", BS, BS)
            r = eng.submit(s, a=f"a{d}", b=f"b{d}", c=f"c{i}", alpha=1.0, beta=0.0)
            assert r.wait(60) and r.state == "done", r.info()
    wl.disable_sink()
    return wl.read_trace(path)


def _replay(eng, wl, tm, stream, sessions):
    """Replay a stream serialized; returns {request_id: checksum} and
    the product-cache hits."""
    cache, out, hits = {}, {}, 0
    for entry in stream:
        s = sessions.get(entry["tenant"])
        if s is None:
            s = sessions[entry["tenant"]] = eng.open_session(entry["tenant"])
        kwargs = wl.stage_entry(s, entry, cache)
        r = wl.replay_submit(eng, s, entry, kwargs)
        assert r.wait(60) and r.state == "done", r.info()
        hits += int(bool((r.result or {}).get("cached")))
        out[entry["request_id"]] = float(tm.checksum(s.get(kwargs["c"])))
    return out, hits


def test_jax_trace_replays_in_the_port(tmp_path):
    jeng = _live(jax_serve.ServeEngine(start=True))
    records = _record(jeng, jax_wl, str(tmp_path / "jax.jsonl"))
    assert len(records) == 8
    assert workload.read_trace(str(tmp_path / "jax.jsonl")) == records
    for seed in (0, 5):
        assert json.dumps(workload.request_stream(records, seed), sort_keys=True) == \
            json.dumps(jax_wl.request_stream(records, seed), sort_keys=True)
    stream = workload.request_stream(records, seed=3)
    want, jhits = _replay(jeng, jax_wl, jax_tm, jax_wl.request_stream(records, seed=3), {})
    peng = _live(serve.ServeEngine(start=True, device="cpu"))
    got, phits = _replay(peng, workload, port_tm, stream, {})
    assert set(got) == set(want)
    for rid in want:
        assert got[rid] == pytest.approx(want[rid], rel=1e-11)
    # the recorded repeat structure (half the requests repeat a pair)
    # reproduces as the same product-cache hits in both packages
    assert phits == jhits == 4


def test_port_trace_reads_in_the_jax_package(tmp_path):
    peng = _live(serve.ServeEngine(start=True, device="cpu"))
    path = str(tmp_path / "port.jsonl")
    records = _record(peng, workload, path)
    assert jax_wl.read_trace(path) == records
    rec = records[0]
    assert rec["kind"] == "workload_request" and rec["schema"] == jax_wl.WORKLOAD_SCHEMA
    assert set(rec["operands"]) == {"a", "b", "c"}
    ops = rec["operands"]["a"]
    assert ops["dtype"] == "float64" and len(ops["digest"]) == 40
    assert ops["row_blk"] == BS and "data" not in json.dumps(rec)
    assert json.dumps(jax_wl.request_stream(records, 1), sort_keys=True) == \
        json.dumps(workload.request_stream(records, 1), sort_keys=True)
    jeng = _live(jax_serve.ServeEngine(start=True))
    want, _ = _replay(jeng, jax_wl, jax_tm, jax_wl.request_stream(records, 1), {})
    got, _ = _replay(peng, workload, port_tm, workload.request_stream(records, 1), {})
    for rid in want:
        assert got[rid] == pytest.approx(want[rid], rel=1e-11)


def test_fit_and_synthesize_agree_with_jax(tmp_path):
    jeng = _live(jax_serve.ServeEngine(start=True))
    records = _record(jeng, jax_wl, str(tmp_path / "jax.jsonl"))
    model = workload.fit(records)
    assert model == jax_wl.fit(records)
    for row in model["tenants"].values():
        assert row["repeat_rate"] == 0.5
    for kw in ({}, {"rate_x": 2.0, "tenants_x": 2.0, "repeat_rate": 0.25}):
        assert workload.synthesize(model, duration_s=2.0, seed=3, **kw) == \
            jax_wl.synthesize(model, duration_s=2.0, seed=3, **kw)
    assert workload.fit([]) == jax_wl.fit([])
    assert workload.derive_seed("ab", 0) == jax_wl.derive_seed("ab", 0) == 0xB278C76B


def test_recorder_off_is_inert_and_replay_fault_sheds(tmp_path):
    peng = _live(serve.ServeEngine(start=True, device="cpu"))
    assert not workload.sink_active()
    s = peng.open_session("t")
    s.random("a", BS, BS, occupation=0.6, seed=1)
    s.random("b", BS, BS, occupation=0.6, seed=2)
    s.create("c", BS, BS)
    r = peng.submit(s, a="a", b="b", c="c")
    assert r.wait(60) and r.state == "done"
    assert not metrics.counter_items("dbcsr_tpu_workload_records_total")
    entry = {"request_id": "x-1", "op": "multiply", "priority": 10, "deadline_s": None}
    faults.configure("replay_submit:raise,times=1")
    with pytest.raises(Exception):
        workload.replay_submit(peng, s, entry, {"a": "a", "b": "b", "c": "c"})
    assert peng.get_request("x-1") is None  # never reached the engine
    t = workload.replay_submit(peng, s, entry, {"a": "a", "b": "b", "c": "c"})
    assert t.wait(60) and t.state == "done"
    workload.note_replay("t", "done")
    assert metrics.counter_items("dbcsr_tpu_replay_requests_total")
