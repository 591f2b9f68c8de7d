"""The port's integrity plane (dbcsr_tpu_torch.acc.abft, the chain
snapshot/restore of core.mempool, models.integrity and the guarded model
loops) held against the JAX package on the CPU.

* ABFT: the same tolerances, the same probe vectors; on one numpy-seeded
  stack both packages pass the clean launch and flag the same ``flip``
  with relative errors, tolerances and scales that agree within 1e-12
  relative, for a launch into a nonzero C and into a zero one.
* Stack flips under ``abft="verify"`` are recovered bit for bit, at
  once (beta != 0) and through the deferred flush (beta = 0), with the
  mismatch and recovery counters balanced; with the knob off the probe
  is blind.  A canvas flip falls over to the stack format in both
  packages, counted alike.
* Snapshots restore twice, refuse a retired matrix, and make the norm
  memo miss; the memo sees a block flipped in place.
* The guarded purify, sign and invsqrt loops at 6 block rows of 4 under
  ``execute_stack:flip``: the chain invariant rolls back in both
  packages, the port ends bit for bit on its clean loop and within
  1e-12 of the JAX package's guarded loop; under ``abft="verify"`` the
  probe is the detector and nothing rolls back; a corruption on every
  launch ends in `ChainIntegrityError`.

Both packages run the stack format (the canvas formats would take the
full iterates), and the autouse fixture clears both packages' fault
specs, breakers, metrics, events and flight rings around every test.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbcsr_tpu.acc import abft as jax_abft
from dbcsr_tpu.acc import smm as jax_smm
from dbcsr_tpu.core import mempool as jax_mempool
from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.mm import multiply as jax_mm
from dbcsr_tpu.models import invsqrt as jax_invsqrt
from dbcsr_tpu.models import purify as jax_purify
from dbcsr_tpu.models import sign as jax_sign
from dbcsr_tpu.obs import costmodel as jax_costmodel
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import flight as jax_flight
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.resilience import breaker as jax_breaker
from dbcsr_tpu.resilience import faults as jax_faults

from dbcsr_tpu_torch.acc import abft
from dbcsr_tpu_torch.acc import smm as port_smm
from dbcsr_tpu_torch.core import mempool
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.mm import multiply as port_mm
from dbcsr_tpu_torch.models import integrity
from dbcsr_tpu_torch.models import (
    invsqrt_iteration,
    make_test_density,
    mcweeny_purify,
    sign_iteration,
)
from dbcsr_tpu_torch.obs import costmodel, events, flight, metrics
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.ops.operations import scale
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


_JAX_CFG = ("mm_driver", "mm_format", "mm_dense", "incremental", "abft")
_PORT_CFG = ("mm_driver", "mm_format", "mm_dense", "abft")


def _clear_both():
    for f, b, m, e, fl in ((faults, breaker, metrics, events, flight),
                           (jax_faults, jax_breaker, jax_metrics, jax_events, jax_flight)):
        f.clear()
        b.reset_board()
        m.reset()
        e.clear()
        fl.clear()
    jax_health.reset()
    abft.discard_pending()
    jax_abft.discard_pending()
    port_mm.clear_plan_cache()
    jax_mm._plan_cache.clear()


@pytest.fixture(autouse=True)
def clean_both():
    jcfg = {k: getattr(jax_get_config(), k) for k in _JAX_CFG}
    pcfg = {k: getattr(get_config(), k) for k in _PORT_CFG}
    _clear_both()
    jax_set_config(mm_format="stack", incremental="off")
    set_config(mm_format="stack")
    yield
    _clear_both()
    jax_set_config(**jcfg)
    set_config(**pcfg)


def _ctr(m, name, **labels) -> float:
    items = m.counter_items(name)
    return sum(v for lab, v in items if all(lab.get(k) == x for k, x in labels.items()))


# ------------------------------------------------------------------ ABFT
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("k,depth", [(1, 1), (23, 1), (23, 529), (5, 4000)])
def test_abft_tolerance_matches_jax(dtype, k, depth):
    assert costmodel.abft_tolerance(dtype, k, depth) == \
        jax_costmodel.abft_tolerance(dtype, k, depth)


def test_abft_config_validation_matches_jax():
    for mode in ("off", "verify", "recover"):
        set_config(abft=mode)
        jax_set_config(abft=mode)
        assert abft.mode() == jax_abft.mode() == mode
        assert abft.enabled() == jax_abft.enabled() == (mode != "off")
        assert abft.recover_enabled() == jax_abft.recover_enabled() == (mode == "recover")
    for setter in (set_config, jax_set_config):
        with pytest.raises(ValueError, match="abft"):
            setter(abft="bogus")


@pytest.mark.parametrize("n,salt", [(23, 0), (23, 1), (5, 1), (64, 0)])
def test_probe_vectors_match_jax(n, salt):
    got = abft.probe_vector(n, torch.float64, salt=salt)
    want = np.asarray(jax_abft.probe_vector(n, jnp.float64, salt=salt))
    np.testing.assert_array_equal(got.numpy(), want)
    assert abft.probe_vector(n, torch.bfloat16, salt=salt).dtype == torch.float32


def _stack(seed, m=5, n=6, k=7, c_zero=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((12, m, k))
    b = rng.standard_normal((9, k, n))
    c = np.zeros((8, m, n)) if c_zero else rng.standard_normal((8, m, n))
    ci = np.sort(rng.integers(0, 8, 60)).astype(np.int32)
    return a, b, c, rng.integers(0, 12, 60).astype(np.int32), \
        rng.integers(0, 9, 60).astype(np.int32), ci


def _probe_both(seed, c_zero, spec=None):
    """One stack through both packages' `execute_stack` under
    ``abft="verify"``; returns both results and both packages'
    ``abft_mismatch`` events."""
    a, b, c, ai, bi, ci = _stack(seed, c_zero=c_zero)
    jax_set_config(abft="verify", mm_driver="xla")
    set_config(abft="verify", mm_driver="torch")
    jplan = jax_smm.prepare_stack(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), ai, bi, ci)
    pplan = port_smm.prepare_stack(torch.from_numpy(c), torch.from_numpy(a),
                                   torch.from_numpy(b), ai, bi, ci)
    pc = torch.from_numpy(c.copy())
    if spec is None:
        jout = jax_smm.execute_stack(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), jplan,
                                     1.5, c_zero=c_zero)
        port_smm.execute_stack(pc, torch.from_numpy(a), torch.from_numpy(b), pplan, 1.5,
                               c_zero=c_zero)
    else:
        with jax_faults.inject_faults(spec):
            jout = jax_smm.execute_stack(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                                         jplan, 1.5, c_zero=c_zero)
        with faults.inject_faults(spec):
            port_smm.execute_stack(pc, torch.from_numpy(a), torch.from_numpy(b), pplan, 1.5,
                                   c_zero=c_zero)
    return (np.asarray(jout), pc.numpy(), jax_events.records(kind="abft_mismatch"),
            events.records(kind="abft_mismatch"))


@pytest.mark.parametrize("c_zero", [False, True])
@pytest.mark.parametrize("seed", [3, 17])
def test_stack_probe_flags_the_same_flip_as_jax(c_zero, seed):
    jout, pout, jmis, pmis = _probe_both(seed, c_zero)
    assert jmis == pmis == []
    np.testing.assert_allclose(pout, jout, rtol=1e-12, atol=1e-12)
    _clear_both()
    jout2, pout2, jmis, pmis = _probe_both(seed, c_zero, spec=f"execute_stack:flip,seed={seed}"
                                           ",times=1")
    assert len(jmis) == len(pmis) == 1
    for key in ("rel_err", "tolerance", "scale"):
        assert pmis[0][key] == pytest.approx(jmis[0][key], rel=1e-12), key
    assert pmis[0]["shape"] == jmis[0]["shape"] and pmis[0]["site"] == jmis[0]["site"]
    # both recovered on the same driver from the pristine C, bit for bit
    np.testing.assert_array_equal(jout2, jout)
    np.testing.assert_array_equal(pout2, pout)
    for m, drv in ((metrics, "torch"), (jax_metrics, "xla")):
        assert _ctr(m, "dbcsr_tpu_abft_mismatches_total", driver=drv) == 1
        assert _ctr(m, "dbcsr_tpu_abft_recoveries_total", driver=drv) == 1
        assert _ctr(m, "dbcsr_tpu_driver_failures_total", driver=drv, kind="sdc") == 1


def _port_ops(seed, occ=0.6, occ_c=0.3, sizes=(5,) * 6):
    rng = np.random.default_rng(seed)
    bs = list(sizes)
    return [port_tm.make_random_matrix(n, bs, bs, occupation=o, rng=rng, device="cpu")
            for n, o in (("A", occ), ("B", occ), ("C", occ_c))]


@pytest.mark.parametrize("beta,times", [(0.5, 1), (0.0, 1), (0.0, 2)])
def test_stack_flip_recovered_bitwise_with_balanced_counters(beta, times):
    ref_a, ref_b, ref_c = _port_ops(1)
    port_mm.multiply("N", "N", 1.5, ref_a, ref_b, beta, ref_c)
    a, b, c = _port_ops(1)
    set_config(abft="verify")
    with faults.inject_faults(f"execute_stack:flip,seed=5,times={times}") as sp:
        port_mm.multiply("N", "N", 1.5, a, b, beta, c)
    assert sp[0].fired == times
    np.testing.assert_array_equal(port_tm.to_dense(c), port_tm.to_dense(ref_c))
    mis = _ctr(metrics, "dbcsr_tpu_abft_mismatches_total")
    assert mis >= 1 and _ctr(metrics, "dbcsr_tpu_abft_recoveries_total") == mis
    assert _ctr(metrics, "dbcsr_tpu_driver_failures_total", kind="sdc") >= 1
    assert abft.pending_count() == 0


def test_abft_off_is_blind():
    ref_a, ref_b, ref_c = _port_ops(2)
    port_mm.multiply("N", "N", 1.0, ref_a, ref_b, 0.0, ref_c)
    a, b, c = _port_ops(2)
    with faults.inject_faults("execute_stack:flip,seed=5,times=1") as sp:
        port_mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    assert sp[0].fired == 1
    assert _ctr(metrics, "dbcsr_tpu_abft_checks_total") == 0
    assert not (port_tm.to_dense(c) == port_tm.to_dense(ref_c)).all()


def test_dense_flip_degrades_to_the_stack_format_as_in_jax():
    rng = np.random.default_rng(4)
    bs = [5] * 6
    jops = [jax_tm.make_random_matrix(n, bs, bs, occupation=0.95, rng=rng) for n in "ABC"]
    pops = [matrix_from_numpy_state(
        {"row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
         "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype), "keys": m.keys,
         "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
         "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in m.bins]},
        device="cpu") for m in jops]
    jax_set_config(abft="verify", mm_format="dense")
    set_config(abft="verify", mm_format="dense")
    with jax_faults.inject_faults("dense:flip,seed=7,times=1"):
        jax_mm.multiply("N", "N", 2.0, jops[0], jops[1], 0.5, jops[2])
    with faults.inject_faults("dense:flip,seed=7,times=1") as sp:
        port_mm.multiply("N", "N", 2.0, pops[0], pops[1], 0.5, pops[2])
    assert sp[0].fired == 1
    assert jops[2]._mm_algorithm == pops[2]._mm_algorithm == "stack"
    for m in (metrics, jax_metrics):
        assert _ctr(m, "dbcsr_tpu_abft_mismatches_total", driver="dense") == 1
        assert _ctr(m, "dbcsr_tpu_abft_recoveries_total", driver="dense") == 1
        assert _ctr(m, "dbcsr_tpu_driver_fallback_total", **{"from": "dense", "to": "stack"}) == 1
    got, want = port_tm.to_dense(pops[2]), jax_tm.to_dense(jops[2])
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_composite_flip_is_caught_by_the_batched_probe():
    sizes = [4] * 8
    rng = np.random.default_rng(40)
    ops = []
    for name in "ABC":
        m = BlockSparseMatrix(name, sizes, sizes, device="cpu")
        for r in range(8):
            for c in range(max(0, r - 1), min(8, r + 2)):
                m.put_block(r, c, rng.standard_normal((4, 4)))
        ops.append(m.finalize())
    ref = ops[2].copy()
    set_config(mm_format="stack")
    port_mm.multiply("N", "N", 1.0, ops[0], ops[1], 1.0, ref)
    set_config(abft="verify", mm_format="composite")
    with faults.inject_faults("dense:flip,seed=3,times=1") as sp:
        port_mm.multiply("N", "N", 1.0, ops[0], ops[1], 1.0, ops[2])
    assert sp[0].fired == 1 and ops[2]._mm_algorithm == "stack"
    assert _ctr(metrics, "dbcsr_tpu_abft_mismatches_total", driver="composite") == 1
    np.testing.assert_allclose(port_tm.to_dense(ops[2]), port_tm.to_dense(ref),
                               rtol=1e-12, atol=1e-12)


# ------------------------------------------------------ snapshot, memo
def _density(seed=7, nblk=6, bsize=4):
    return make_test_density(nblk, bsize, occ=0.4, seed=seed, device="cpu")


def test_snapshot_restores_twice_and_caches_miss():
    m = _density()
    before = port_tm.to_dense(m)
    norms0 = m.block_norms()
    assert m.block_norms() is norms0  # memo hit
    fp0 = m.pattern_fingerprint()
    with mempool.chain() as ch:
        snap = ch.snapshot(m)
        scale(m, 3.0)
        assert not (port_tm.to_dense(m) == before).all()
        ch.restore(snap)
        np.testing.assert_array_equal(port_tm.to_dense(m), before)
        assert m.block_norms() is not norms0  # new bins: the memo missed
        np.testing.assert_array_equal(m.block_norms(), norms0)
        assert m.pattern_fingerprint() == fp0
        scale(m, -1.0)
        ch.restore(snap)  # a snapshot installs fresh clones: reusable
        np.testing.assert_array_equal(port_tm.to_dense(m), before)
        assert snap.nbytes() == sum(b.data.numel() * 8 for b in m.bins)
        assert all(b.data is not d for b, (_, d, _) in zip(m.bins, snap.bins))


def test_restore_after_retire_is_a_structured_error():
    with mempool.chain() as outer:
        m = _density()
        outer.adopt(m)
        snap = outer.snapshot(m)
        with mempool.chain() as inner:
            scale(m, 2.0)
            inner.restore(snap)  # fine while m lives
            outer.retire(m)
            with pytest.raises(mempool.SnapshotError, match="retired"):
                inner.restore(snap)
    with jax_mempool.chain() as ch:
        jm = jax_purify.make_test_density(6, 4, occ=0.4, seed=7)
        ch.adopt(jm)
        jsnap = ch.snapshot(jm)
        ch.retire(jm)
        with pytest.raises(jax_mempool.SnapshotError):
            ch.restore(jsnap)


def test_norm_memo_sees_in_place_writes():
    m = _density(seed=3)
    norms = m.block_norms()
    assert not norms.flags.writeable
    b = m.bins[0].data
    slot = int(m.ent_slot[m.ent_bin == 0][0])
    entry = int(np.nonzero((m.ent_bin == 0) & (m.ent_slot == slot))[0][0])
    with faults.inject_faults(f"x:flip,seed={slot * 16},times=1"):
        faults.corrupt("x", b)  # flips element 0 of that block, in place
    flipped = m.block_norms()
    assert flipped is not norms and flipped[entry] != norms[entry]
    np.testing.assert_array_equal(np.delete(flipped, entry), np.delete(norms, entry))
    mempool.set_enabled(False)
    try:
        assert m.block_norms() is not m.block_norms()  # no memo with the pool off
    finally:
        mempool.set_enabled(True)


# -------------------------------------------------------- guarded loops
def _loops(model):
    jd = jax_purify.make_test_density(6, 4, occ=0.4, seed=7)
    pd = _density()
    if model == "purify":
        return (lambda: jax_purify.mcweeny_purify(jd, steps=3)), \
            (lambda: mcweeny_purify(pd, steps=3))
    if model == "sign":
        return (lambda: jax_sign.sign_iteration(jd, steps=4)), \
            (lambda: sign_iteration(pd, steps=4))
    return (lambda: jax_invsqrt.invsqrt_iteration(jd, max_iter=4)), \
        (lambda: invsqrt_iteration(pd, max_iter=4))


@pytest.mark.parametrize("model", ["purify", "sign", "invsqrt"])
@pytest.mark.parametrize("seed", [13, 21])
def test_guarded_loops_roll_back_in_both_packages(model, seed):
    jloop, ploop = _loops(model)
    clean = port_tm.to_dense(ploop()[0])
    spec = f"execute_stack:flip,seed={seed},times=1"
    with jax_faults.inject_faults(spec) as jsp:
        jout = jax_tm.to_dense(jloop()[0])
    with faults.inject_faults(spec) as psp:
        pres = ploop()
    assert jsp[0].fired == psp[0].fired == 1
    for m in (metrics, jax_metrics):
        assert _ctr(m, "dbcsr_tpu_chain_rollback_total", model=model) >= 1
        assert _ctr(m, "dbcsr_tpu_abft_recoveries_total", driver=f"chain:{model}") >= 1
    pout = port_tm.to_dense(pres[0])
    np.testing.assert_array_equal(pout, clean)
    assert np.abs(pout - jout).max() <= 1e-12 * np.abs(jout).max()
    assert [r["model"] for r in events.records(kind="chain_rollback")][0] == model


def test_a_sign_rollback_is_counted_in_the_models_totals():
    _, ploop = _loops("sign")
    port_mm.reset_totals()
    with faults.inject_faults("execute_stack:flip,seed=13,times=1") as sp:
        _, history = ploop()
    assert sp[0].fired == 1
    rolled = _ctr(metrics, "dbcsr_tpu_chain_rollback_total", model="sign")
    assert rolled >= 1
    assert port_mm.read_totals()["models"]["sign"] == {"loops": 1, "steps": len(history),
                                                       "rollbacks": rolled}


@pytest.mark.parametrize("model", ["purify", "sign", "invsqrt"])
def test_probe_is_the_detector_under_verify(model):
    _, ploop = _loops(model)
    clean = port_tm.to_dense(ploop()[0])
    set_config(abft="verify")
    with faults.inject_faults("execute_stack:flip,seed=13,times=1") as sp:
        out = port_tm.to_dense(ploop()[0])
    assert sp[0].fired == 1
    assert _ctr(metrics, "dbcsr_tpu_chain_rollback_total") == 0
    assert _ctr(metrics, "dbcsr_tpu_abft_recoveries_total") >= 1
    np.testing.assert_array_equal(out, clean)


def test_unguarded_loop_is_untouched_and_snapshots_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(mempool.chain, "snapshot", lambda self, m: calls.append(m))
    assert not integrity.guard_enabled()
    _, history = mcweeny_purify(_density(), steps=3)
    assert calls == [] and len(history) == 3


def test_persistent_corruption_raises_chain_integrity_error():
    before = (get_config().mm_driver, get_config().mm_dense)
    with faults.inject_faults("execute_stack:flip,seed=13"):
        with pytest.raises(integrity.ChainIntegrityError, match="safe-engine"):
            mcweeny_purify(_density(), steps=2)
    assert (get_config().mm_driver, get_config().mm_dense) == before


def test_norm_bound_and_safe_engine():
    assert integrity.norm_ok(1.0, 1.0) and not integrity.norm_ok(float("nan"), 1.0)
    assert not integrity.norm_ok(1e4, 1.0)
    with integrity.safe_engine():
        assert get_config().mm_driver == "pallas" and get_config().mm_dense is False
