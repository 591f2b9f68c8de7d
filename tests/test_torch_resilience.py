"""The port's resilience plane (dbcsr_tpu_torch.resilience, the guarded
`acc.smm.execute_stack`, the host driver, the crosspack demotion and the
canvas-to-stack failover) held against the JAX package on the CPU.

* The fault DSL: the same spec strings parse alike, fire on the same
  calls, and corrupt the same element by the same delta.
* The breakers: the same record sequences, under one injected clock,
  drive both boards through the same states and transitions.
* `native.host_smm` against the JAX package's `native.host_smm` on one
  numpy-seeded stack: within 1e-14 relative (f32, f64).
* Under ``pallas:raise,times=1`` (on integer-valued float32 operands,
  whose products both packages compute exactly, since the JAX package's
  Pallas kernel takes float32 only) and ``dense:raise,times=1`` (f64),
  both packages' products agree within 1e-12 and both count one
  failure and one failover.
* The port alone: non-finite output, the breaker opening after three
  failures, the crosspack demotion, the planning fault, the flight
  recorder's events, the registry of sites, and the production path,
  which clones and syncs nothing.

The autouse fixture clears both packages' fault specs, breaker boards,
metrics, events and flight rings before and after every test, so no
breaker is left open for a later test of either package.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbcsr_tpu import native as jax_native
from dbcsr_tpu.acc import smm as jax_smm
from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.core.matrix import BlockSparseMatrix as JaxMatrix
from dbcsr_tpu.mm import multiply as jax_mm
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import flight as jax_flight
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.resilience import breaker as jax_breaker
from dbcsr_tpu.resilience import faults as jax_faults
from dbcsr_tpu.resilience import sites as jax_sites

from dbcsr_tpu_torch import native
from dbcsr_tpu_torch.acc import crosspack_kernel, stack_kernel
from dbcsr_tpu_torch.acc import smm as port_smm
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.mm import multiply as port_mm
from dbcsr_tpu_torch.obs import events, flight, metrics
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.resilience import breaker, faults, sites

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_CFG = ("mm_driver", "mm_format", "mm_dense", "incremental", "abft", "validate_kernels")
_PORT_CFG = ("mm_driver", "mm_format", "mm_dense", "abft", "validate_kernels")


def _clear_both():
    for f, b, m, e, fl in ((faults, breaker, metrics, events, flight),
                           (jax_faults, jax_breaker, jax_metrics, jax_events, jax_flight)):
        f.clear()
        b.reset_board()
        m.reset()
        e.clear()
        fl.clear()
    jax_health.reset()
    port_mm.clear_plan_cache()
    jax_mm._plan_cache.clear()


@pytest.fixture(autouse=True)
def clean_both():
    jcfg = {k: getattr(jax_get_config(), k) for k in _JAX_CFG}
    pcfg = {k: getattr(get_config(), k) for k in _PORT_CFG}
    cross = set(port_smm._cross_disabled)
    jcross = set(jax_smm._cross_disabled)
    _clear_both()
    jax_set_config(mm_format="stack", incremental="off")
    yield
    _clear_both()
    jax_set_config(**jcfg)
    set_config(**pcfg)
    port_smm._cross_disabled.clear()
    port_smm._cross_disabled.update(cross)
    jax_smm._cross_disabled.clear()
    jax_smm._cross_disabled.update(jcross)


def _ctr(m, name, **labels) -> float:
    """A counter's value at ``labels``, or summed over every label set."""
    items = m.counter_items(name)
    if labels:
        return sum(v for lab, v in items if all(lab.get(k) == x for k, x in labels.items()))
    return sum(v for _, v in items)


def _jax_state(m) -> dict:
    return {"row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
            "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype),
            "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
            "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in m.bins]}


def _pair(name, sizes, occ, seed, dtype=np.float64, integer=False):
    """One matrix in both packages from one numpy seed: the JAX package
    draws it, the port takes its state.  ``integer`` rounds the values
    to integers in [-4, 4] (exact float32 products)."""
    rng = np.random.default_rng(seed)
    jm = jax_tm.make_random_matrix(name, sizes, sizes, dtype=dtype, occupation=occ, rng=rng)
    if integer:
        jm.map_bin_data(lambda d: jnp.round(d * 4.0))
    return jm, matrix_from_numpy_state(_jax_state(jm), device="cpu")


def _operands(sizes=(4,) * 6, occ=0.6, dtype=np.float64, integer=False, seed=0):
    return [_pair(n, list(sizes), occ, seed + i, dtype, integer)
            for i, n in enumerate("ABC")]


# ------------------------------------------------------------------ faults
SPECS = ["pallas:raise@stack>=3,prob=0.5,seed=7", "execute_stack:flip,seed=13,times=2",
         "dense:nan,times=1", "torch:oom@stack==2", "pallas_cross:raise@stack<3,times=5",
         "prepare_stack:raise;execute_stack:nan@stack>1,prob=0.3,seed=4"]


@pytest.mark.parametrize("spec", SPECS)
def test_specs_parse_and_fire_as_in_jax(spec):
    got, want = faults.parse(spec), jax_faults.parse(spec)
    fields = ("target", "kind", "op", "n", "prob", "seed", "times", "sleep")
    assert [[getattr(s, f) for f in fields] for s in got] == \
        [[getattr(s, f) for f in fields] for s in want]
    calls = [("execute_stack", {"driver": d}) for d in ("pallas", "torch", "pallas_cross")] * 8
    calls += [("prepare_stack", {}), ("dense", {})] * 4
    fired = [[], []]
    for i, spec_list in enumerate((got, want)):
        for site, labels in calls:
            fired[i].append([s.matches(site, labels) and s.should_fire() for s in spec_list])
    assert fired[0] == fired[1]
    assert [s.calls for s in got] == [s.calls for s in want]


@pytest.mark.parametrize("kind", ["flip", "nan"])
@pytest.mark.parametrize("seed", [0, 5, 13, 1021])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_corruption_hits_the_same_element_by_the_same_delta(kind, seed, dtype):
    x = np.random.default_rng(seed).standard_normal((7, 5, 3)).astype(dtype)
    spec = f"site_x:{kind},seed={seed},times=1"
    with jax_faults.inject_faults(spec):
        want = np.asarray(jax_faults.corrupt("site_x", jnp.asarray(x)))
    got = torch.from_numpy(x.copy())
    version = got._version
    with faults.inject_faults(spec) as sp:
        out = faults.corrupt("site_x", got)
        again = faults.corrupt("site_x", got)  # times exhausted: untouched
    assert out is got and again is got and sp[0].fired == 1
    assert got._version > version  # in place, and visible to version-keyed caches
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != x).sum() == 1  # NaN differs from everything
    assert np.isnan(got.numpy()).sum() == (kind == "nan")


@pytest.mark.parametrize("kind,want", [("raise", "runtime"), ("oom", "oom"),
                                       ("fail", "runtime")])
def test_injected_errors_classify_as_in_jax(kind, want):
    for f, classify in ((faults, port_smm._classify_failure),
                        (jax_faults, jax_smm._classify_failure)):
        with f.inject_faults(f"execute_stack:{kind}"):
            with pytest.raises(RuntimeError) as err:
                f.maybe_inject("execute_stack", driver="pallas")
        assert classify(err.value) == want
    with faults.inject_faults("execute_stack:raise"):
        with pytest.raises(RuntimeError, match="CUDA error"):
            faults.maybe_inject("execute_stack")
    assert _ctr(metrics, "dbcsr_tpu_faults_injected_total", kind=kind) == 1 + (kind == "raise")


def test_every_injection_site_is_registered_and_matches_jax():
    literal = re.compile(r"(?:maybe_inject|corrupt)\(\s*\"([A-Za-z0-9_]+)\"")
    found = set()
    for dirpath, _, files in os.walk(os.path.join(ROOT, "dbcsr_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    found |= set(literal.findall(fh.read()))
    assert found == set(sites.SITES)
    for name, meta in sites.SITES.items():
        jmeta = jax_sites.SITES[name]
        assert {k: meta[k] for k in ("corruptible", "chaos", "dynamic")} == \
            {k: jmeta[k] for k in ("corruptible", "chaos", "dynamic")}
    assert set(sites.DRIVER_TARGETS) == set(port_smm._FAILOVER_CHAIN)


# ---------------------------------------------------------------- breakers
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


RECORDS = [("fail", "runtime"), ("fail", "runtime"), ("allow", None), ("fail", "oom"),
           ("allow", None), ("tick", 29.0), ("allow", None), ("tick", 2.0), ("allow", None),
           ("allow", None), ("fail", "runtime"), ("tick", 59.0), ("allow", None),
           ("tick", 2.0), ("allow", None), ("ok", None), ("allow", None),
           ("fail", "validation"), ("allow", None), ("tick", 31.0), ("allow", None),
           ("ok", None), ("fail", "sdc"), ("ok", None)]


def test_breakers_walk_the_same_transitions_as_jax():
    clocks = (_Clock(), _Clock())
    boards = (breaker.BreakerBoard(fail_threshold=3, cooldown_s=30.0, clock=clocks[0]),
              jax_breaker.BreakerBoard(fail_threshold=3, cooldown_s=30.0, clock=clocks[1]))
    key = (23, 23, 23, "float64")
    trace = ([], [])
    for op, arg in RECORDS:
        for i, (board, clock) in enumerate(zip(boards, clocks)):
            if op == "fail":
                board.record_failure("pallas", key, kind=arg)
            elif op == "ok":
                board.record_success("pallas", key)
            elif op == "tick":
                clock.t += arg
            else:
                trace[i].append(board.allow("pallas", key))
            trace[i].append((board.state("pallas", key), board.snapshot()))
    assert trace[0] == trace[1]
    states = {s for s, _ in (x for x in trace[0] if isinstance(x, tuple))}
    assert states == {breaker.CLOSED, breaker.OPEN, breaker.HALF_OPEN}
    got = [(r["to"], r["transition"]) for r in events.records(kind="breaker_transition")]
    want = [(r["to"], r["transition"]) for r in jax_events.records(kind="breaker_transition")]
    assert got == want and ("open", "hard-failure") in got
    assert metrics.snapshot()["gauges"] == {
        k: v for k, v in jax_metrics.snapshot()["gauges"].items() if k == "dbcsr_tpu_breaker_state"}


# ------------------------------------------------------------- host driver
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mnk", [(23, 23, 23), (5, 13, 7), (4, 4, 4)])
def test_host_smm_matches_jax(dtype, mnk):
    m, n, k = mnk
    rng = np.random.default_rng(sum(mnk))
    a = rng.standard_normal((40, m, k)).astype(dtype)
    b = rng.standard_normal((30, k, n)).astype(dtype)
    c = rng.standard_normal((20, m, n)).astype(dtype)
    ci = np.sort(rng.integers(0, 20, 400)).astype(np.int32)
    ai = rng.integers(0, 40, 400).astype(np.int32)
    bi = rng.integers(0, 30, 400).astype(np.int32)
    want = c.copy()
    assert jax_native.host_smm(want, a, b, ai, bi, ci, 1.25)
    got = torch.from_numpy(c.copy())
    native.host_smm(got, torch.from_numpy(a), torch.from_numpy(b), ai, bi, ci, 1.25)
    rel = np.abs(got.numpy().astype(np.float64) - want).max() / np.abs(want).max()
    assert rel <= 1e-14


def test_host_driver_runs_cpu_stacks_and_refuses_other_devices():
    rng = np.random.default_rng(3)
    a, b, c = (torch.from_numpy(rng.standard_normal(s)) for s in
               ((10, 5, 6), (9, 6, 7), (4, 5, 7)))
    ci = np.array([0, 0, 1, 3, 3, 3])
    ai, bi = rng.integers(0, 10, 6), rng.integers(0, 9, 6)
    set_config(mm_driver="host")
    plan = port_smm.prepare_stack(c, a, b, ai, bi, ci)
    assert plan.driver == "host" and plan.label == "host" and plan.kernel == "host_smm"
    got = port_smm.execute_stack(c.clone(), a, b, plan, 0.5)
    set_config(mm_driver="torch")
    want = port_smm.process_stack(c.clone(), a, b, ai, bi, ci, 0.5)
    torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)
    set_config(mm_driver="host")
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in (a, b, c)]
    with pytest.raises(ValueError, match="CPU tensors only"):
        port_smm.prepare_stack(meta[2], meta[0], meta[1], ai, bi, ci)
    with pytest.raises(TypeError, match="float32/float64"):
        port_smm.prepare_stack(c.bfloat16(), a.bfloat16(), b.bfloat16(), ai, bi, ci)
    with pytest.raises(ValueError, match="CPU tensors only"):
        native.host_smm(meta[2], meta[0], meta[1], ai, bi, ci, 1.0)


# ------------------------------------------------ failovers, both packages
def _multiply_both(ops, alpha=1.0, beta=0.5, spec=None):
    (ja, pa), (jb, pb), (jc, pc) = ops
    jc, pc = jc.copy(), pc.copy()
    if spec is None:
        jax_mm.multiply("N", "N", alpha, ja, jb, beta, jc)
        port_mm.multiply("N", "N", alpha, pa, pb, beta, pc)
    else:
        with jax_faults.inject_faults(spec) as jsp:
            jax_mm.multiply("N", "N", alpha, ja, jb, beta, jc)
        with faults.inject_faults(spec) as psp:
            port_mm.multiply("N", "N", alpha, pa, pb, beta, pc)
        assert jsp[0].fired == psp[0].fired == 1
    return jax_tm.to_dense(jc), port_tm.to_dense(pc), (jc, pc)


def test_launch_failover_matches_jax():
    jax_set_config(mm_driver="pallas")
    set_config(mm_driver="pallas")
    ops = _operands(dtype=np.float32, integer=True, seed=11)
    clean_j, clean_p, _ = _multiply_both(ops, beta=1.0)
    np.testing.assert_array_equal(clean_j, clean_p)  # exact integer products
    _clear_both()
    got_j, got_p, _ = _multiply_both(ops, beta=1.0, spec="pallas:raise,times=1")
    scale = np.abs(clean_j).max()
    assert np.abs(got_j - clean_j).max() <= 1e-12 * scale
    assert np.abs(got_p - got_j).max() <= 1e-12 * scale
    for m, chain_next in ((metrics, "torch"), (jax_metrics, "xla_group")):
        assert _ctr(m, "dbcsr_tpu_driver_failures_total") == 1
        assert _ctr(m, "dbcsr_tpu_driver_failures_total", driver="pallas", kind="runtime") == 1
        assert _ctr(m, "dbcsr_tpu_driver_fallback_total") == 1
        assert _ctr(m, "dbcsr_tpu_driver_fallback_total", **{"from": "pallas",
                                                            "to": chain_next}) == 1


@pytest.mark.parametrize("fmt", ["dense", "composite"])
def test_canvas_failover_matches_jax(fmt):
    if fmt == "composite":  # a banded pattern: narrow k-support per row panel
        sizes = [4] * 8
        ops = []
        for i, name in enumerate("ABC"):
            jm = JaxMatrix(name, sizes, sizes)
            rng = np.random.default_rng(40 + i)
            for r in range(8):
                for c in range(max(0, r - 1), min(8, r + 2)):
                    jm.put_block(r, c, rng.standard_normal((4, 4)))
            jm.finalize()
            ops.append((jm, matrix_from_numpy_state(_jax_state(jm), device="cpu")))
    else:
        ops = _operands(occ=0.95, seed=21)
    jax_set_config(mm_format=fmt)
    set_config(mm_format=fmt)
    clean_j, clean_p, (jc, pc) = _multiply_both(ops, alpha=2.0)
    assert jc._mm_algorithm == pc._mm_algorithm == fmt
    _clear_both()
    got_j, got_p, (jc, pc) = _multiply_both(ops, alpha=2.0, spec="dense:raise,times=1")
    assert jc._mm_algorithm == pc._mm_algorithm == "stack"
    scale = np.abs(clean_j).max()
    for got in (got_j, got_p):
        assert np.abs(got - clean_j).max() <= 1e-12 * scale
    for m in (metrics, jax_metrics):
        assert _ctr(m, "dbcsr_tpu_driver_failures_total", driver=fmt, kind="runtime") == 1
        assert _ctr(m, "dbcsr_tpu_driver_fallback_total", **{"from": fmt, "to": "stack"}) == 1


# ------------------------------------------------------------- the port
def _port_operands(seed=0, dtype=torch.float64, sizes=(4,) * 6, occ=0.6):
    rng = np.random.default_rng(seed)
    return [port_tm.make_random_matrix(n, list(sizes), list(sizes), dtype=dtype,
                                       occupation=occ, rng=rng, device="cpu") for n in "ABC"]


def _port_product(spec=None, beta=0.5, seed=0, **kw):
    a, b, c = _port_operands(seed, **kw)
    if spec is None:
        port_mm.multiply("N", "N", 1.0, a, b, beta, c)
        return c, None
    with faults.inject_faults(spec) as sp:
        port_mm.multiply("N", "N", 1.0, a, b, beta, c)
    return c, sp


def test_non_finite_output_is_classified_and_recovered():
    set_config(mm_format="stack")
    clean, _ = _port_product()
    got, sp = _port_product("execute_stack:nan,times=1")
    assert sp[0].fired == 1
    np.testing.assert_array_equal(port_tm.to_dense(got), port_tm.to_dense(clean))
    assert _ctr(metrics, "dbcsr_tpu_driver_failures_total", driver="pallas", kind="nan") == 1
    assert _ctr(metrics, "dbcsr_tpu_driver_fallback_total", **{"from": "pallas",
                                                               "to": "torch"}) == 1


def test_oom_is_transient_and_classified():
    set_config(mm_format="stack")
    _port_product("execute_stack:oom,times=1")
    assert _ctr(metrics, "dbcsr_tpu_driver_failures_total", kind="oom") == 1


def test_breaker_opens_after_three_failures_and_quarantines():
    set_config(mm_format="stack")
    key = (4, 4, 4, "float64")
    with faults.inject_faults("pallas:raise") as sp:
        for seed in range(3):
            c, _ = _port_product(seed=seed)
            assert np.isfinite(port_tm.checksum(c))
        board = breaker.get_board()
        assert board.state("pallas", key) == breaker.OPEN
        calls = sp[0].calls
        stack_kernel.reset_counts()
        _port_product(seed=3)
        assert sp[0].calls == calls  # quarantined: no pallas launch attempted
    assert _ctr(metrics, "dbcsr_tpu_driver_failures_total", driver="pallas") == 3
    assert _ctr(metrics, "dbcsr_tpu_driver_fallback_total", **{"from": "pallas",
                                                               "to": "torch"}) == 4
    states = [r["to"] for r in events.records(kind="breaker_transition")]
    assert states[-1] == "open"


@pytest.mark.parametrize("kind,demoted", [("raise", True), ("oom", False)])
def test_crosspack_failure_demotes_only_when_deterministic(kind, demoted):
    set_config(mm_driver="pallas_cross", mm_format="stack")
    clean, _ = _port_product(dtype=torch.float32)
    crosspack_kernel.reset_counts()
    got, sp = _port_product(f"pallas_cross:{kind}", dtype=torch.float32)
    key = (4, 4, 4, "float32")
    assert (key in port_smm._cross_disabled) is demoted
    np.testing.assert_allclose(port_tm.to_dense(got), port_tm.to_dense(clean),
                               rtol=1e-5, atol=1e-5)
    assert _ctr(metrics, "dbcsr_tpu_driver_failures_total", driver="pallas_cross") >= 1
    assert _ctr(metrics, "dbcsr_tpu_driver_fallback_total", **{"from": "pallas_cross",
                                                               "to": "pallas"}) >= 1
    assert [r["session"] for r in events.records(kind="crosspack_demoted")][0] is demoted
    a, b, c = (x.bins[0].data for x in _port_operands(dtype=torch.float32))
    port_mm.clear_plan_cache()
    plan = port_smm.prepare_stack(c, a, b, [0, 1], [0, 1], [0, 0])
    assert plan.driver == ("kernel" if demoted else "crosspack")


def test_prepare_fault_replans_on_the_plain_driver():
    set_config(mm_format="stack")
    clean, _ = _port_product()
    port_mm.clear_plan_cache()
    got, sp = _port_product("prepare_stack:raise,times=1")
    assert sp[0].fired == 1
    np.testing.assert_allclose(port_tm.to_dense(got), port_tm.to_dense(clean),
                               rtol=1e-13, atol=1e-13)
    assert _ctr(metrics, "dbcsr_tpu_driver_fallback_total", **{"from": "prepare",
                                                               "to": "torch"}) == 1


def test_prepare_fault_on_the_card_replans_on_the_base_kernel(monkeypatch):
    """On the card a planning failure re-plans on K1, not on the plain
    version (a patched `_on_card` stands in for CUDA tensors)."""
    monkeypatch.setattr(port_smm, "_on_card", lambda c_data: True)
    rng = np.random.default_rng(5)
    a, b, c = (torch.from_numpy(rng.standard_normal(s)) for s in
               ((10, 5, 6), (9, 6, 7), (4, 5, 7)))
    ci, ai, bi = np.array([0, 0, 1, 3, 3, 3]), rng.integers(0, 10, 6), rng.integers(0, 9, 6)
    with faults.inject_faults("prepare_stack:raise,times=1") as sp:
        plan = port_smm.prepare_stack(c, a, b, ai, bi, ci)
    assert sp[0].fired == 1 and plan.label == "pallas"
    assert metrics.counter_items("dbcsr_tpu_driver_fallback_total") == [
        ({"from": "prepare", "to": "pallas"}, 1.0)]


@pytest.mark.parametrize("driver", ["pallas", "pallas_cross", "torch"])
def test_plan_gives_back_its_stack(driver):
    """A failover plans the stack again from the plan's own arrays (no
    host copy is kept on the production path): the read-back stack is
    the one planned, and no plan but the host driver's pins host
    arrays."""
    rng = np.random.default_rng(8)
    a, b, c = (torch.from_numpy(rng.standard_normal(s)) for s in
               ((30, 4, 4), (20, 4, 4), (12, 4, 4)))
    ci = np.sort(rng.integers(0, 12, 200))
    ai, bi = rng.integers(0, 30, 200), rng.integers(0, 20, 200)
    set_config(mm_driver=driver)
    plan = port_smm.prepare_stack(c, a, b, ai, bi, ci)
    assert plan.label == driver and plan.host_idx is None
    for got, want in zip(plan.stack(), (ai, bi, ci)):
        np.testing.assert_array_equal(got, want)


def test_flight_and_bus_carry_the_failover():
    set_config(mm_format="stack")
    _port_product("execute_stack:raise,times=1")
    recs = flight.records()
    assert recs and recs[-1]["algorithm"] == "stack" and "phases_ms" in recs[-1]
    kinds = {e["event"] for r in recs for e in r.get("events", [])}
    assert {"fault_injected", "driver_failure", "failover", "breaker"} <= kinds
    pids = {r["product_id"] for r in events.records() if r["event"] != "breaker_transition"}
    assert len(pids) == 1 and None not in pids
    assert [r["event"] for r in events.records(kind="multiply_end")] == ["multiply_end"]
    assert metrics.counter_items("dbcsr_tpu_driver_fallback_total") == [
        ({"from": "pallas", "to": "torch"}, 1.0)]


def test_build_failures_never_enter_the_chain(monkeypatch):
    from dbcsr_tpu_torch.acc.build import BuildError

    def broken(*args, **kw):
        raise BuildError("nvcc failed for smm_stack.cu")

    monkeypatch.setattr(stack_kernel, "smm_stack", broken)
    set_config(mm_format="stack")
    with pytest.raises(BuildError):
        _port_product()
    assert metrics.counter_items("dbcsr_tpu_driver_failures_total") == []


def test_production_path_clones_and_syncs_nothing(monkeypatch):
    counts = {"clone": 0, "probe": 0, "finite": 0}
    real_clone = torch.Tensor.clone

    def counting_clone(self, *args, **kw):
        counts["clone"] += 1
        return real_clone(self, *args, **kw)

    def counted(name, fn):
        def wrapper(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return wrapper

    set_config(mm_format="stack")
    a, b, c = _port_operands(seed=8)
    monkeypatch.setattr(port_smm.abft, "stack_probe", counted("probe", port_smm.abft.stack_probe))
    monkeypatch.setattr(port_smm, "_output_corrupted", counted("finite",
                                                               port_smm._output_corrupted))
    monkeypatch.setattr(torch.Tensor, "clone", counting_clone)
    port_mm.multiply("N", "N", 1.0, a, b, 0.5, c)
    assert counts == {"clone": 0, "probe": 0, "finite": 0}
    set_config(abft="verify")
    port_mm.multiply("N", "N", 1.0, a, b, 0.5, c)
    assert counts["clone"] > 0 and counts["probe"] > 0
    assert _ctr(metrics, "dbcsr_tpu_abft_mismatches_total") == 0


def test_probe_faults_histograms_and_subscribers_match_jax():
    for f in (faults, jax_faults):
        with f.inject_faults("probe:fail,times=2"):
            assert [f.fail_probe() for _ in range(3)] == [True, True, False]
        assert f.fail_probe() is False  # nothing configured
    for m in (metrics, jax_metrics):
        h = m.histogram("t_seconds", "test", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 3.0):
            h.observe(v, site="x")
    got = metrics.snapshot()["histograms"]["t_seconds"]
    want = jax_metrics.snapshot()["histograms"]["t_seconds"]
    assert got == want
    seen = []
    events.subscribe(seen.append)
    events.subscribe(seen.append)  # idempotent
    try:
        rec = events.publish("x_event", {"kind": "payload"})
    finally:
        events.unsubscribe(seen.append)
    assert seen == [rec] and rec["event"] == "x_event" and rec["kind"] == "payload"
    events.set_enabled(False)
    try:
        assert events.publish("y_event") is None and not events.enabled()
    finally:
        events.set_enabled(True)
    assert [r["event"] for r in events.records()] == ["fault_injected"] * 2 + ["x_event"]
