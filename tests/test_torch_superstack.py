"""Superstack fusion in the port (dbcsr_tpu_torch.acc.smm.execute_superstack
and the fused launch of acc.stack_kernel), on the CPU, where the fused
launch runs its plain version.

The counterparts of `tests/test_superstack.py` that apply: on mixed
blockings (every C bin takes several spans) the fused product is bit for
bit the per-span product at (alpha, beta) in {(1, 0), (1, 0.5), (-2, 1)}
and within 1e-12 of a dense oracle; a beta = 0 first touch; at most one
dispatch per C bin; "auto" fuses and a typo raises; a quarantined span
routes its bin per span; the fused plans are reused on a repeat and
rebuilt after a heal; the torch and host families; an injected
``execute_superstack`` raise or NaN decomposes bit for bit; repeated
failures open the ``fused`` breaker; the fused breaker is never wedged
half-open; ABFT covers a fused bin with one probe; and
`superstack_bytes` keeps the per-span convention.  The merged run table
of the fused kernel is checked against the spans' runs, and the port's
fused product on a `mixed_blocks.perf`-style blocking ({5, 13, 23} and a
short last block) against the JAX package's fused product within
`kernel_validation_tolerance`.

Every test resets both packages' faults, breakers, metrics, events,
health model and plan caches, and restores both configs.
"""

import json

import numpy as np
import pytest
import torch

from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.mm import multiply as jax_mm
from dbcsr_tpu.obs import costmodel as jax_costmodel
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.resilience import breaker as jax_breaker
from dbcsr_tpu.resilience import faults as jax_faults

from dbcsr_tpu_torch import native
from dbcsr_tpu_torch.acc import smm, stack_kernel
from dbcsr_tpu_torch.acc.crosspack import runs
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.mm import incremental
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.obs import costmodel, events, metrics
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.perf.driver import expand_block_sizes
from dbcsr_tpu_torch.resilience import breaker, faults


@pytest.fixture(autouse=True)
def reset_jax_plane():
    """The JAX package's runs in these tests feed its metrics, health
    model, events and telemetry store: all four are reset after every
    test, so a later file in the same worker (`tests/test_tune.py`'s
    admission checks) does not start from a DEGRADED or CRITICAL
    verdict."""
    yield
    for reset in (jax_metrics.reset, jax_health.reset, jax_events.clear, jax_timeseries.reset):
        reset()


_CFG = ("mm_driver", "superstack", "mm_format", "incremental", "abft")


@pytest.fixture(autouse=True)
def clean_both():
    pcfg = {k: getattr(get_config(), k) for k in _CFG}
    jcfg = {k: getattr(jax_get_config(), k) for k in _CFG}

    def clear():
        for f, b, m, e in ((faults, breaker, metrics, events),
                           (jax_faults, jax_breaker, jax_metrics, jax_events)):
            f.clear()
            b.reset_board()
            m.reset()
            e.clear()
        jax_health.reset()
        mm.clear_plan_cache()
        jax_mm._plan_cache.clear()
        incremental.reset()

    clear()
    set_config(mm_format="stack", incremental="off")
    yield
    clear()
    set_config(**pcfg)
    jax_set_config(**jcfg)


# mixed blockings: two row/col/k block sizes, so every C bin takes one
# span per k size
RBS = [5, 3, 5, 3, 5]
KBS = [4, 2, 4, 2]
CBS = [3, 5, 3]


def _mats(occ=0.7, occ_c=0.4, seed=7):
    rng = np.random.default_rng(seed)
    return [port_tm.make_random_matrix(name, r, c, occupation=o, rng=rng, device="cpu")
            for name, r, c, o in (("a", RBS, KBS, occ), ("b", KBS, CBS, occ),
                                  ("c", RBS, CBS, occ_c))]


def _fresh_c():
    return BlockSparseMatrix("c", RBS, CBS, device="cpu")


def _run(mode, alpha=1.0, beta=0.5, seed=7, fresh_c=False):
    """One product under ``superstack=mode`` from a cleared plan cache and
    metrics; returns (dense C, metrics snapshot, C)."""
    set_config(superstack=mode)
    mm.clear_plan_cache()
    metrics.reset()
    a, b, c = _mats(seed=seed)
    if fresh_c:
        c, beta = _fresh_c(), 0.0
    mm.multiply("N", "N", alpha, a, b, beta, c)
    return port_tm.to_dense(c), metrics.snapshot(), c


def _dispatches(snap) -> dict:
    out = {"fused": 0, "per_span": 0}
    for key, v in snap["counters"].get("dbcsr_tpu_dispatches_total", {}).items():
        out[json.loads(key)["mode"]] = v
    return out


def _first_fused(entry):
    return next((cb, sp) for cb, (_drv, sp) in entry.super_plans.items() if sp is not None)


# ------------------------------------------------------------- correctness
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (1.0, 0.5), (-2.0, 1.0)])
def test_fused_matches_per_span_bitwise(alpha, beta):
    """Fusion runs the same products in the same order: bit for bit the
    per-span product, and within 1e-12 of the dense oracle (f64)."""
    ref, _, _ = _run("per_span", alpha=alpha, beta=beta)
    got, snap, _ = _run("fused", alpha=alpha, beta=beta)
    assert np.array_equal(ref, got)
    a, b, c = _mats()
    want = alpha * (port_tm.to_dense(a) @ port_tm.to_dense(b)) + beta * port_tm.to_dense(c)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert _dispatches(snap)["fused"] >= 1


def test_fused_beta0_zero_bins_first_touch():
    ref, _, _ = _run("per_span", fresh_c=True)
    got, snap, _ = _run("fused", fresh_c=True)
    assert np.array_equal(ref, got)
    assert _dispatches(snap)["fused"] >= 1


def test_fused_dispatches_at_most_one_per_c_bin():
    """Multi-span bins fuse into one dispatch, single-span bins stay per
    span; the histogram saw every fused launch, each of >= 2 spans."""
    _, snap, c = _run("fused")
    d = _dispatches(snap)
    assert d["fused"] >= 1
    assert d["fused"] + d["per_span"] <= len(c.bins)
    (row,) = snap["histograms"]["dbcsr_tpu_fused_spans"].values()
    assert row["count"] == d["fused"] and row["sum"] >= 2 * d["fused"]
    spans = {}
    for sp in c._mm_spans:
        spans[(sp[0], sp[1])] = spans.get((sp[0], sp[1]), 0) + 1
    assert d["fused"] == sum(n > 1 for n in spans.values())
    _, snap_ps, _ = _run("per_span")
    assert _dispatches(snap_ps) == {"fused": 0, "per_span": len(c._mm_spans)}


def test_auto_mode_is_fused_and_a_typo_raises():
    set_config(superstack="auto")
    assert mm._superstack_mode() == "fused"
    set_config(superstack="per_span")
    assert mm._superstack_mode() == "per_span"
    with pytest.raises(ValueError, match="superstack"):
        set_config(superstack="per-span")
    assert get_config().superstack == "per_span"  # a rejected update changes nothing


def test_quarantined_span_driver_routes_bin_per_span():
    set_config(superstack="fused")
    a, b, _ = _mats()
    mm.multiply("N", "N", 1.0, a, b, 0.0, _fresh_c())
    (entry,) = mm._plan_cache.values()
    _, splan = _first_fused(entry)
    label = splan.plans[0].label
    board = breaker.get_board()
    for sp in entry.spans:
        for _ in range(board.fail_threshold):
            board.record_failure(label, (sp.m, sp.n, sp.k, "float64"), kind="runtime")
    metrics.reset()
    mm.multiply("N", "N", 1.0, a, b, 0.0, _fresh_c())
    assert _dispatches(metrics.snapshot())["fused"] == 0
    assert [r["why"] for r in events.records(kind="superstack_decompose")][0] \
        == f"span-breaker:{label}"


def test_fused_plan_reused_across_repeats():
    set_config(superstack="fused")
    a, b, _ = _mats()
    c1 = _fresh_c()
    mm.multiply("N", "N", 1.0, a, b, 0.0, c1)
    (entry,) = mm._plan_cache.values()
    fused = {cb: sp for cb, (_drv, sp) in entry.super_plans.items() if sp is not None}
    assert fused
    c2 = _fresh_c()
    mm.multiply("N", "N", 1.0, a, b, 0.0, c2)
    assert c2._mm_plan_cache == "hit"
    (entry2,) = mm._plan_cache.values()
    assert entry2 is entry
    for cb, sp in fused.items():
        assert entry2.super_plans[cb][1] is sp
    assert port_tm.checksum(c1) == port_tm.checksum(c2)
    assert mm._plan_cache_bytes == sum(e.nbytes for e in mm._plan_cache.values()) > 0


def test_stale_superstack_rebuilt_after_heal():
    """A failover heals span plans in place to another driver: the cached
    fused plan is rebuilt (here refused, the bin now mixing families), and
    a cached refusal is reconsidered once the drivers heal back."""
    set_config(superstack="fused")
    a, b, _ = _mats()
    mm.multiply("N", "N", 1.0, a, b, 0.0, _fresh_c())
    (entry,) = mm._plan_cache.values()
    cbin, splan = _first_fused(entry)
    plans = splan.plans
    group = [sp for sp in entry.spans if sp.cbin == cbin]

    def prepare(ps):
        return smm.prepare_superstack(ps, [(sp.m, sp.n, sp.k) for sp in group],
                                      torch.zeros((1, group[0].m, group[0].n),
                                                  dtype=torch.float64))

    old = plans[0].driver
    plans[0].driver = "torch"
    assert entry.superstack_for(cbin, plans, prepare) is None
    plans[0].driver = old
    rebuilt = entry.superstack_for(cbin, plans, prepare)
    assert rebuilt is not None and rebuilt is not splan and rebuilt.family == "pallas"


@pytest.mark.parametrize("driver,family", [("torch", "torch"), ("host", "host")])
def test_fused_families_match_per_span(driver, family):
    """The plain-version family (the JAX package's XLA family) and the
    host driver's family: bit for bit their per-span products."""
    if driver == "host" and not native.host_smm_supports(torch.float64):
        pytest.fail("the native host driver did not build")
    set_config(mm_driver=driver)
    ref, _, _ = _run("per_span")
    got, snap, _ = _run("fused")
    assert np.array_equal(ref, got)
    assert _dispatches(snap)["fused"] >= 1
    (entry,) = mm._plan_cache.values()
    assert {sp.family for _, sp in entry.super_plans.values() if sp is not None} == {family}


def test_prepare_refuses_what_cannot_fuse():
    """Native real forms of one family only: a complex C, a demoted span,
    a crosspack span or mixed drivers keep the per-span path."""
    set_config(superstack="fused")
    a, b, _ = _mats()
    mm.multiply("N", "N", 1.0, a, b, 0.0, _fresh_c())
    (entry,) = mm._plan_cache.values()
    cbin, splan = _first_fused(entry)
    plans = splan.plans
    shapes = [(sp.m, sp.n, sp.k) for sp in entry.spans if sp.cbin == cbin]
    real = torch.zeros((1, 5, 3), dtype=torch.float64)
    assert smm.prepare_superstack(plans, shapes, real).family == "pallas"
    assert smm.prepare_superstack(plans[:1], shapes[:1], real) is None
    assert smm.prepare_superstack(plans, shapes, real.to(torch.complex128)) is None
    for attr, value in (("precision", ("float32", True)), ("driver", "crosspack"),
                        ("driver", "host")):
        prev = getattr(plans[-1], attr)
        setattr(plans[-1], attr, value)
        try:
            assert smm.prepare_superstack(plans, shapes, real) is None, (attr, value)
        finally:
            setattr(plans[-1], attr, prev)


# -------------------------------------------------------------- the kernel
def test_superstack_table_merges_the_spans_runs():
    """One run per C block, its segments in span order, each segment one
    run of one span: every (span, run) exactly once."""
    rng = np.random.default_rng(3)
    run_ptrs, run_cs = [], []
    for _ in range(4):
        ci = np.sort(rng.integers(0, 40, 60))
        rp, rc = runs(ci)
        run_ptrs.append(rp)
        run_cs.append(rc)
    seg_span, seg_beg, seg_end, run_ptr, run_c = (
        t.numpy() for t in stack_kernel.superstack_table(run_ptrs, run_cs, "cpu"))
    assert np.array_equal(run_c, np.unique(np.concatenate(run_cs)))
    seen = set()
    for r, cblk in enumerate(run_c):
        segs = range(run_ptr[r], run_ptr[r + 1])
        assert list(seg_span[segs]) == sorted(seg_span[segs])  # span order
        for j in segs:
            s = seg_span[j]
            k = int(np.searchsorted(run_cs[s], cblk))
            assert run_cs[s][k] == cblk
            assert (seg_beg[j], seg_end[j]) == (run_ptrs[s][k], run_ptrs[s][k + 1])
            seen.add((s, k))
    assert seen == {(s, k) for s in range(4) for k in range(len(run_cs[s]))}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_launch_on_the_cpu_is_the_plain_sequence(dtype):
    """On a CPU tensor the wrapper runs `smm_superstack_plain`, which is
    the spans' `smm_stack_plain` in order: bit for bit."""
    rng = np.random.default_rng(11)
    m, n, nc = 5, 7, 30
    c0 = torch.from_numpy(rng.standard_normal((nc, m, n))).to(dtype)
    spans, rps, rcs = [], [], []
    for k in (3, 8, 5):
        a = torch.from_numpy(rng.standard_normal((20, m, k))).to(dtype)
        b = torch.from_numpy(rng.standard_normal((25, k, n))).to(dtype)
        ci = np.sort(rng.integers(0, nc, 90))
        rp, rc = runs(ci)
        up = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int32))  # noqa: E731
        spans.append((a, b, up(rng.integers(0, 20, 90)), up(rng.integers(0, 25, 90)),
                       up(rp), up(rc)))
        rps.append(rp)
        rcs.append(rc)
    seq = c0.clone()
    for sp in spans:
        stack_kernel.smm_stack_plain(seq, *sp, -0.5)
    stack_kernel.reset_counts()
    got = stack_kernel.smm_superstack(c0.clone(), spans,
                                      stack_kernel.superstack_table(rps, rcs, "cpu"), -0.5)
    assert torch.equal(got, seq)
    assert stack_kernel.superstack_launches == 0 and stack_kernel.plain_calls == 3
    with pytest.raises(TypeError):
        stack_kernel.smm_superstack(c0.to(torch.complex128), spans, None)


# ------------------------------------------------------------------- chaos
def test_fault_in_fused_launch_decomposes_identically():
    ref, _, _ = _run("per_span", fresh_c=True)
    set_config(superstack="fused")
    mm.clear_plan_cache()
    metrics.reset()
    a, b, _ = _mats()
    c = _fresh_c()
    with faults.inject_faults("execute_superstack:raise,times=1"):
        mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    assert np.array_equal(port_tm.to_dense(c), ref)
    assert metrics.counter_items("dbcsr_tpu_driver_fallback_total") == [
        ({"from": "fused", "to": "per_span"}, 1.0)]
    assert [lab for lab, _ in metrics.counter_items("dbcsr_tpu_faults_injected_total")] == [
        {"site": "execute_superstack", "kind": "raise"}]
    assert len(events.records(kind="superstack_decompose")) == 1


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_fault_corruption_in_fused_launch_decomposes(beta):
    """A NaN written by the fused launch is caught by the finite check
    (on under injection) and the bin re-runs per span from its pristine
    C: the clone (beta 0.5) or zeros (beta 0)."""
    ref, _, _ = _run("per_span", beta=beta)
    set_config(superstack="fused")
    mm.clear_plan_cache()
    a, b, c = _mats()
    with faults.inject_faults("execute_superstack:nan,times=1"):
        mm.multiply("N", "N", 1.0, a, b, beta, c)
    assert np.array_equal(port_tm.to_dense(c), ref)
    assert metrics.counter_items("dbcsr_tpu_driver_failures_total") == [
        ({"driver": "fused", "kind": "nan"}, 1.0)]


def test_repeated_fused_failures_open_breaker():
    set_config(superstack="fused")
    a, b, _ = _mats()
    with faults.inject_faults("execute_superstack:raise"):
        for _ in range(4):
            mm.multiply("N", "N", 1.0, a, b, 0.0, _fresh_c())
    rows = {k: v for k, v in breaker.get_board().snapshot().items() if k.startswith("fused|")}
    assert rows and any(r["state"] == "open" for r in rows.values())
    before = {k: v["failures"] for k, v in rows.items()}
    with faults.inject_faults("execute_superstack:raise"):
        c = _fresh_c()
        mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    after = breaker.get_board().snapshot()
    for k, n in before.items():
        if rows[k]["state"] == "open":
            assert after[k]["failures"] == n
    ref, _, _ = _run("per_span", fresh_c=True)
    assert np.array_equal(port_tm.to_dense(c), ref)


def test_fused_breaker_not_wedged_half_open_by_span_breaker():
    """Both the fused breaker (cooldown over) and a span breaker open:
    the bin decomposes on the span breaker without taking the fused
    half-open trial, so the fused breaker still reads plain open."""
    set_config(superstack="fused")
    a, b, _ = _mats()
    c = _fresh_c()
    mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    (entry,) = mm._plan_cache.values()
    cbin, splan = _first_fused(entry)
    bin_key = smm._superstack_key(c.bins[cbin].data, len(splan.plans))
    t = [0.0]
    board = breaker.BreakerBoard(clock=lambda: t[0])
    breaker._board = board
    for _ in range(board.fail_threshold):
        board.record_failure("fused", bin_key, kind="runtime")
    for sp in entry.spans:
        for _ in range(board.fail_threshold):
            board.record_failure(splan.plans[0].label, (sp.m, sp.n, sp.k, "float64"),
                                 kind="runtime")
    assert board.state("fused", bin_key) == breaker.OPEN
    t[0] += board.cooldown_s * 20
    c2 = _fresh_c()
    mm.multiply("N", "N", 1.0, a, b, 0.0, c2)
    assert board.state("fused", bin_key) == breaker.OPEN
    assert port_tm.checksum(c2) == port_tm.checksum(c)


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_abft_probes_a_fused_bin_once(beta):
    """Under "verify" a fused bin is probed once (the ``fused`` checks),
    with no mismatch and the bits of "off"; a flip in the fused launch is
    caught by the probe and the bin recomputed per span, bit for bit."""
    ref, _, _ = _run("fused", beta=beta)
    set_config(abft="verify")
    got, snap, _ = _run("fused", beta=beta)
    assert np.array_equal(ref, got)
    checks = dict((lab["driver"], v) for lab, v in
                  metrics.counter_items("dbcsr_tpu_abft_checks_total"))
    assert checks["fused"] == _dispatches(snap)["fused"] >= 1
    assert metrics.counter_items("dbcsr_tpu_abft_mismatches_total") == []
    mm.clear_plan_cache()
    metrics.reset()
    a, b, c = _mats()
    with faults.inject_faults("execute_superstack:flip,seed=5,times=1"):
        mm.multiply("N", "N", 1.0, a, b, beta, c)
    assert np.array_equal(port_tm.to_dense(c), ref)
    assert metrics.counter_items("dbcsr_tpu_abft_mismatches_total") == [
        ({"driver": "fused"}, 1.0)]
    assert ({"driver": "fused"}, 1.0) in metrics.counter_items("dbcsr_tpu_abft_recoveries_total")


# ---------------------------------------------------------- the cost model
def test_superstack_bytes_matches_per_span_convention():
    spans = [(5, 3, 4, 100), (5, 3, 2, 40)]
    fused = costmodel.superstack_bytes(spans, nseg=64, itemsize=8)
    assert fused == costmodel.stack_bytes(5, 3, 4, 100, nseg=64, itemsize=8) + \
        costmodel.stack_bytes(5, 3, 2, 40, nseg=0, itemsize=8)
    assert fused < sum(costmodel.stack_bytes(*s, nseg=64, itemsize=8) for s in spans)
    assert fused == jax_costmodel.superstack_bytes(spans, nseg=64, itemsize=8)


def test_fused_rollup_bytes_below_per_span():
    _, snap_ps, _ = _run("per_span", fresh_c=True)
    _, snap_f, _ = _run("fused", fresh_c=True)

    def total(snap):
        return sum(r["bytes_moved"] for r in snap["roofline"].values())
    assert total(snap_f) < total(snap_ps)
    assert snap_f["flops_by_driver"] == snap_ps["flops_by_driver"]


def test_sync_timing_tags_roofline_rows(monkeypatch):
    monkeypatch.setenv("DBCSR_TPU_TORCH_SYNC_TIMING", "1")
    got, snap, _ = _run("fused")
    assert snap["roofline"] and all(r["sync"] is True for r in snap["roofline"].values())
    monkeypatch.delenv("DBCSR_TPU_TORCH_SYNC_TIMING")
    got2, snap2, _ = _run("fused")
    assert all(r["sync"] is False for r in snap2["roofline"].values())
    assert np.array_equal(got, got2)


# ------------------------------------------------------- against the JAX package
def _jax_state(m) -> dict:
    from dbcsr_tpu.core.kinds import enum_of

    return {"row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
            "matrix_type": m.matrix_type, "dtype": enum_of(m.dtype),
            "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
            "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in m.bins]}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_mixed_blocks_fused_against_the_jax_package(dtype):
    """A `mixed_blocks.perf`-style blocking (sizes cycling 5, 13, 23 over
    283 rows, the last block cut to 19), drawn by the JAX package and
    carried across: the port's fused product against the JAX package's
    fused product within `kernel_validation_tolerance` at the deepest k
    (relative to max |C|); every multi-span bin of the port fused (the
    JAX package fuses a bin only where its spans share a driver family)."""
    sizes = [int(x) for x in expand_block_sizes(283, [(1, 5), (1, 13), (1, 23)])]
    assert sizes[-1] == 19
    rng = np.random.default_rng(20261017)
    jm = [jax_tm.make_random_matrix(n, sizes, sizes, dtype=dtype, occupation=o, rng=rng)
          for n, o in (("A", 0.3), ("B", 0.3), ("C", 0.2))]
    pm = [matrix_from_numpy_state(_jax_state(m), device="cpu") for m in jm]
    jax_set_config(superstack="auto", mm_format="stack", incremental="off")
    set_config(superstack="auto")
    jax_mm.multiply("N", "N", 0.9, jm[0], jm[1], 0.4, jm[2])
    mm.multiply("N", "N", 0.9, pm[0], pm[1], 0.4, pm[2])
    want, got = jax_tm.to_dense(jm[2]).astype(np.float64), port_tm.to_dense(pm[2])
    tol = costmodel.kernel_validation_tolerance(np.dtype(dtype).name, max(sizes),
                                                len(sizes))
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))
    j_fused = sum(v for k, v in jax_metrics.snapshot()["counters"][
        "dbcsr_tpu_dispatches_total"].items() if json.loads(k)["mode"] == "fused")
    nspans: dict = {}
    for sp in pm[2]._mm_spans:
        nspans[sp[:2]] = nspans.get(sp[:2], 0) + 1
    assert _dispatches(metrics.snapshot())["fused"] == sum(n > 1 for n in nspans.values())
    assert j_fused >= 1


def test_adaptive_precision_bins_keep_the_per_span_path():
    """The counterpart of the JAX package's fused mixed-k adaptive test:
    under ``precision="adaptive"`` with ABFT on, every span of a
    multi-span bin is demoted, and a demoted span keeps its bin on the
    per-span path, so "auto" dispatches no fused launch and gives the
    per-span product's bits; every probe passes."""
    from dbcsr_tpu_torch.acc import precision

    prev = get_config().precision
    set_config(precision="adaptive", abft="verify")
    try:
        precision.reset()
        ref, _, _ = _run("per_span")
        precision.reset()
        got, snap, c = _run("auto")
    finally:
        set_config(precision=prev)
        precision.reset()
    assert np.array_equal(ref, got)
    d = _dispatches(snap)
    assert d == {"fused": 0, "per_span": len(c._mm_spans)}
    assert metrics.counter_items("dbcsr_tpu_abft_mismatches_total") == []
    assert sum(v for _, v in metrics.counter_items("dbcsr_tpu_precision_launches_total")) \
        == len(c._mm_spans)
