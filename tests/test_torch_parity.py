"""The port's ops-plane parity with the JAX package, on the CPU:

* `perf.driver`'s checksum gate retries one repeat on its safe driver and
  classifies the failure (`driver`, `transient`, `deterministic`,
  `unstable`, `retry_error`) as the JAX package does
  (`dbcsr_tpu/perf/driver.py:_checksum_retry_safe`): the same outcome,
  counter, event, returned field and message, on the same operands;
  with ``DBCSR_TPU_TORCH_CHECKSUM_RETRY=0`` (`chip_smoke.py`'s gates)
  `run_perf` raises the first mismatch itself, with the JAX message;
* a tensor contraction is one product on the ops plane: its
  ``tensor_contract`` flight record and span attributes, and the TAS
  multiply's (name, m, n, k, long dimension, nsplit), as in the JAX
  package; a demoted stack's span names the precision it ran in;
* a world join with tracing on publishes the ``clock_align`` event the
  JAX package publishes (`dbcsr_tpu/parallel/multihost.py:57-93`).

The autouse fixture resets both packages' metrics, health models, event
rings, flight rings, telemetry stores, SLO windows, incident recorders
and configuration before and after every test, so nothing leaks into
later files of the same process.
"""

import os

import numpy as np
import pytest
import torch

from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.mm.multiply import multiply as jax_multiply
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import flight as jax_flight
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import incidents as jax_incidents
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import slo as jax_slo
from dbcsr_tpu.obs import timeseries as jax_ts
from dbcsr_tpu.obs import tracer as jax_tracer
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.parallel import multihost as jax_multihost
from dbcsr_tpu.perf import driver as jax_driver
from dbcsr_tpu.tensor import contract as jax_contract
from dbcsr_tpu.tensor import create_tensor as jax_create_tensor

from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.mm import multiply as port_mm
from dbcsr_tpu_torch.obs import events, flight, health, incidents, metrics, slo, tracer
from dbcsr_tpu_torch.obs import timeseries as ts
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.parallel import multihost
from dbcsr_tpu_torch.perf import driver as port_driver
from dbcsr_tpu_torch.tensor import contract, create_tensor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, "tests", "inputs")
_CFG = ("mm_driver", "mm_dense", "mm_format", "incremental", "precision", "abft")


def _reset_both() -> None:
    for mod in (metrics, jax_metrics):
        mod.reset()
    for mod in (events, jax_events, flight, jax_flight):
        mod.clear()
    for mod in (health, jax_health, ts, jax_ts, slo, jax_slo, incidents, jax_incidents):
        mod.reset()
    port_mm.clear_plan_cache()


@pytest.fixture(autouse=True)
def clean_both():
    pcfg = {k: getattr(get_config(), k) for k in _CFG}
    jcfg = {k: getattr(jax_get_config(), k) for k in _CFG}
    _reset_both()
    set_config(incremental="off")
    jax_set_config(mm_format="stack", incremental="off")
    yield
    for mod in (tracer, jax_tracer):
        if mod.active():
            mod.disable()
    _reset_both()
    set_config(**pcfg)
    jax_set_config(**jcfg)


# ------------------------------------------------------- checksum retry
def _mats(pkg, seed=0):
    """A, B and C (5x5 blocks, 8 block rows) drawn from one numpy seed,
    alike in both packages (`make_random_matrix` draws bit for bit)."""
    rng = np.random.default_rng(seed)
    bs = [5] * 8
    kw = {} if pkg is jax_tm else {"device": "cpu"}
    a = pkg.make_random_matrix("A", bs, bs, dtype=np.float64, occupation=0.6, rng=rng, **kw)
    b = pkg.make_random_matrix("B", bs, bs, dtype=np.float64, occupation=0.6, rng=rng, **kw)
    c = pkg.make_random_matrix("C", bs, bs, dtype=np.float64, occupation=0.3, rng=rng, **kw)
    return a, b, c


_PKGS = {
    "jax": (jax_driver, jax_tm, jax_multiply, jax_metrics, jax_events, jax_get_config,
            jax_set_config),
    "port": (port_driver, port_tm, port_mm.multiply, metrics, events, get_config, set_config),
}


def _retry(pkg: str, outcome: str):
    """One package's `_checksum_retry_safe` driven to ``outcome``: the
    run's result (or the raised error), its counter and its events."""
    drv, tm, mul, met, ev, getc, setc = _PKGS[pkg]
    if outcome in ("transient", "deterministic"):
        # the whole run on the safe driver, so the retry repeats it
        setc(mm_driver=drv.SAFE_DRIVER)
    a, b, c = _mats(tm)
    mul("N", "N", 1.0, a, b, 0.0, c)
    cs, cs_pos = tm.checksum(c), tm.checksum(c, pos=True)
    good = outcome in ("driver", "transient")
    refs = (cs, cs_pos) if good else (cs * 2.0, 0.0)
    cfg = drv.PerfConfig(check=True, check_threshold=1e-8, check_refs=refs)
    calls = []

    def run_once():
        calls.append(getc().mm_driver)
        if outcome == "retry_error":
            raise RuntimeError("retry boom")
        a2, b2, c2 = _mats(tm)
        mul("N", "N", 1.7 if outcome == "unstable" else 1.0, a2, b2, 0.0, c2)
        return c2, 0, 0.0

    first = drv.PerfChecksumError("simulated corruption")
    cs_first = cs * 1.5 if good else cs
    driver_before = getc().mm_driver
    try:
        res = drv._checksum_retry_safe(cfg, run_once, cs_first=cs_first, first_err=first,
                                       result={"checksum": cs_first}, verbose=False)
        err = None
    except drv.PerfChecksumError as exc:
        res, err = None, str(exc)
    counts = {lab["outcome"]: v for lab, v in met.counter_items("dbcsr_tpu_checksum_retry_total")}
    evs = [r for r in ev.records(kind="checksum_retry")]
    return {"res": res, "err": err, "counts": counts, "events": evs, "calls": calls,
            "restored": getc().mm_driver == driver_before and getc().mm_dense is None,
            "good_cs": cs, "safe": drv.SAFE_DRIVER}


@pytest.mark.parametrize("outcome", ["driver", "transient", "deterministic", "unstable",
                                     "retry_error"])
def test_checksum_retry_classifies_as_in_jax(outcome):
    """Each class of the retry, on the same operands in both packages:
    the same outcome counted once, one ``checksum_retry`` event with the
    same fields, the safe result returned (``driver``, ``transient``) or
    the same message raised, the configuration restored.  The safe
    driver differs by design: K1 (``"pallas"``) in the port, the JAX
    package's ``"xla"``; on CPU tensors both run the plain stack path."""
    got, want = _retry("port", outcome), _retry("jax", outcome)
    assert got["safe"] == "pallas" and want["safe"] == "xla"
    assert got["calls"] == [got["safe"]] and want["calls"] == [want["safe"]]
    assert got["counts"] == want["counts"] == {outcome: 1.0}
    (pe,), (je,) = got["events"], want["events"]
    assert pe["outcome"] == je["outcome"] == outcome
    keys = {"outcome", "safe_driver", "original_mm_driver", "error"}
    assert keys <= set(pe) and keys <= set(je)
    assert pe["error"] == je["error"] == "simulated corruption"
    assert (pe["original_mm_driver"] == "pallas") == (je["original_mm_driver"] == "xla")
    assert got["restored"] and want["restored"]
    if outcome in ("driver", "transient"):
        assert got["err"] is None and want["err"] is None
        for r in (got, want):
            assert r["res"]["checksum"] == pytest.approx(r["good_cs"], rel=1e-12)
            assert r["res"]["checksum_retry"]["outcome"] == outcome
        assert got["res"]["checksum"] == pytest.approx(want["res"]["checksum"], rel=1e-12)
        assert set(got["res"]["checksum_retry"]) == set(want["res"]["checksum_retry"])
    else:
        tail = {"deterministic": "DETERMINISTIC", "unstable": "UNSTABLE",
                "retry_error": "safe-driver retry also failed"}[outcome]
        assert tail in got["err"] and tail in want["err"]
        assert got["err"].replace("pallas", "xla") == want["err"]


def test_run_perf_retries_then_raises_as_in_jax():
    """A `.perf` gate with a wrong reference through `run_perf` in both
    packages: the flight ring dumped, one safe-driver repeat classified
    ``deterministic`` (the same product, the same wrong checksum), the
    error raised; the port's health model then reads the engine
    CRITICAL, as the JAX package's does."""
    errs = {}
    for name, drv in (("port", port_driver), ("jax", jax_driver)):
        cfg = drv.parse_perf_file(os.path.join(INPUTS, "test_square_dense.perf"))
        cfg.nrep = 1
        cfg.check_refs = (cfg.check_refs[0] * 1.5, cfg.check_refs[1])
        kw = {"device": "cpu"} if name == "port" else {}
        with pytest.raises(drv.PerfChecksumError) as info:
            drv.run_perf(cfg, verbose=False, **kw)
        errs[name] = str(info.value)
    assert "DETERMINISTIC" in errs["port"] and "DETERMINISTIC" in errs["jax"]
    got = {lab["outcome"]: v for lab, v in metrics.counter_items("dbcsr_tpu_checksum_retry_total")}
    assert got == {"deterministic": 1.0}
    assert [r["outcome"] for r in events.records(kind="checksum_retry")] == ["deterministic"]
    verdict = health.verdict()["components"]["engine"]
    jverdict = jax_health.verdict()["components"]["engine"]
    assert verdict["status"] == jverdict["status"] == "CRITICAL"


def test_run_perf_without_retry_raises_at_once(monkeypatch):
    """With ``DBCSR_TPU_TORCH_CHECKSUM_RETRY=0`` (what `chip_smoke.py`
    sets for its gates) the port's `run_perf` raises the first mismatch
    itself: the JAX package's `_verify_checksums` message on the same
    checksums, no repeat, no retry counted, no ``checksum_retry`` event."""
    monkeypatch.setenv("DBCSR_TPU_TORCH_CHECKSUM_RETRY", "0")
    cfg = port_driver.parse_perf_file(os.path.join(INPUTS, "test_square_dense.perf"))
    cfg.nrep = 1
    cfg.check_refs = (cfg.check_refs[0] * 1.5, cfg.check_refs[1])
    with pytest.raises(port_driver.PerfChecksumError) as info:
        port_driver.run_perf(cfg, verbose=False, device="cpu")
    cfg.check = False
    res = port_driver.run_perf(cfg, verbose=False, device="cpu")
    jcfg = jax_driver.parse_perf_file(os.path.join(INPUTS, "test_square_dense.perf"))
    jcfg.check_refs = cfg.check_refs
    with pytest.raises(jax_driver.PerfChecksumError) as want:
        jax_driver._verify_checksums(jcfg, res["checksum"], res["checksum_pos"], False)
    assert str(info.value) == str(want.value)
    assert not list(metrics.counter_items("dbcsr_tpu_checksum_retry_total"))
    assert events.records(kind="checksum_retry") == []


# ------------------------------------------- contraction product scope
def _tensors(pkg_create, seed=3):
    """T(i,j,k), M(k,l) and an empty C(i,j,l) drawn from one numpy seed."""
    si, sj, sk, sl = [2, 3], [3, 2], [4, 2], [2, 2]
    kw = ({"dtype": np.float64} if pkg_create is jax_create_tensor
          else {"dtype": torch.float64, "device": "cpu"})
    rng = np.random.default_rng(seed)
    t = pkg_create("T", [si, sj, sk], (0, 1), (2,), **kw)
    m = pkg_create("M", [sk, sl], (0,), (1,), **kw)
    for x, occ in ((t, 0.8), (m, 0.9)):
        for idx in np.ndindex(*[len(b) for b in x.blk_sizes]):
            if rng.random() < occ:
                x.put_block(idx, rng.standard_normal(x.block_shape(idx)))
        x.finalize()
    c = pkg_create("C", [si, sj, sl], (0, 1), (2,), **kw)
    c.finalize()
    return t, m, c


_RI = dict(contract_a=(2,), notcontract_a=(0, 1), contract_b=(0,), notcontract_b=(1,),
           map_1=(0, 1), map_2=(2,))


def _spans(tr, name):
    return [e for e in tr.events if e.get("ev") == "span" and e["name"] == name]


def test_contract_product_scope_and_spans_as_in_jax(tmp_path):
    """One contraction in each package under the tracer: the
    ``tensor_contract`` flight record (its name and fields) and product
    id on the bus, under which the inner multiplies' products nest; the
    contraction span's attributes and the TAS multiply's (name, m, n,
    k, long dimension, nsplit) alike."""
    pt = tracer.enable(str(tmp_path / "port.jsonl"))
    jt = jax_tracer.enable(str(tmp_path / "jax.jsonl"))
    pa, pb, pc = _tensors(create_tensor)
    ja, jb, jc = _tensors(jax_create_tensor)
    assert contract(1.0, pa, pb, 0.0, pc, **_RI) == jax_contract(1.0, ja, jb, 0.0, jc, **_RI)
    tracer.disable()
    jax_tracer.disable()
    for name in ("tensor_contract", "tas_multiply"):
        (ps,), (js,) = _spans(pt, name), _spans(jt, name)
        assert ps["attrs"] == js["attrs"], name
    assert set(_spans(pt, "tensor_contract")[0]["attrs"]) == {
        "a", "b", "c", "contract_a", "contract_b", "ndim_a", "ndim_b", "bounded"}
    assert {"name", "m", "n", "k", "long_dim", "nsplit"} <= set(_spans(pt, "tas_multiply")[0]["attrs"])

    def scope(fl):
        recs = [r for r in fl.records() if r.get("op") == "tensor_contract"]
        assert len(recs) == 1
        return recs[0]
    prec, jrec = scope(flight), scope(jax_flight)
    for key in ("a", "b", "ndim_a", "ndim_b"):
        assert prec[key] == jrec[key], key
    assert prec.get("error") is None and jrec.get("error") is None
    # the contraction's own product on the bus, apart from its multiplies'
    # (its begin and end; what the telemetry plane adds under it depends
    # on the earlier products of the process)
    kinds = [sorted(r["event"] for r in ev.records(product_id=rec["product_id"])
                    if r["event"] in ("multiply_begin", "multiply_end"))
             for ev, rec in ((events, prec), (jax_events, jrec))]
    assert kinds[0] == kinds[1] == ["multiply_begin", "multiply_end"]
    inner = [r["product_id"] for r in flight.records() if r.get("op") == "multiply"]
    assert inner and prec["product_id"] not in inner


def test_prepare_stack_names_the_executed_precision_as_in_jax(tmp_path):
    """A stack demoted to f32 (``precision="f32"``): the spans that carry
    the executed precision, and its value, alike in both packages."""
    out = {}
    for name, tm, mul, setc, tr in (
            ("port", port_tm, port_mm.multiply, set_config, tracer),
            ("jax", jax_tm, jax_multiply, jax_set_config, jax_tracer)):
        setc(precision="f32", abft="off")
        a, b, c = _mats(tm, seed=4)
        t = tr.enable(str(tmp_path / f"{name}.jsonl"))
        mul("N", "N", 1.0, a, b, 0.0, c)
        tr.disable()
        out[name] = sorted((e["name"], e["attrs"]["precision"]) for e in t.events
                           if e.get("ev") == "span" and "precision" in (e.get("attrs") or {}))
    assert out["port"] and out["port"] == out["jax"]
    assert all(p.startswith("float32") for _, p in out["port"])


# ------------------------------------------------------- clock alignment
def test_world_join_publishes_clock_align_as_in_jax(tmp_path, monkeypatch):
    """Two ranks joining a gloo world with tracing on each publish one
    ``clock_align`` event from behind the world's barrier, with the JAX
    package's fields (its single-process join publishes the same
    record); with tracing off nothing is published."""
    jt = jax_tracer.enable(str(tmp_path / "jax.jsonl"))
    jax_multihost._trace_clock_align()
    jax_tracer.disable()
    (want,) = jax_events.records(kind="clock_align")
    assert jt is not None
    monkeypatch.setenv("DBCSR_TPU_TORCH_TRACE", str(tmp_path / "port.jsonl"))
    ranks = multihost.spawn_world("dbcsr_tpu_torch.obs.events:records", 2,
                                  (None, "clock_align"), timeout_s=120.0)
    assert [len(r) for r in ranks] == [1, 1]
    got = [r[0] for r in ranks]
    for rank, rec in enumerate(got):
        assert set(rec) == set(want)
        assert (rec["process"], rec["nproc"], rec["barrier"]) == (rank, 2, "gloo")
        assert rec["event"] == want["event"] == "clock_align"
    assert abs(got[0]["t_unix"] - got[1]["t_unix"]) < 5.0
    monkeypatch.delenv("DBCSR_TPU_TORCH_TRACE")
    multihost._trace_clock_align()  # tracing off: nothing
    assert events.records(kind="clock_align") == []
