"""Symmetric storage in the port held against the JAX package on the CPU.

Symmetric, antisymmetric and real-hermitian draws from one numpy seed,
their folding and unfolding, `desymmetrize`, `new_transposed`, the
numpy-state round trip, multiplies with symmetric operands and a
symmetric C, and `.perf` configurations with symmetric flags.

Tolerances: draws, densified matrices, desymmetrized and transposed
matrices are bit for bit equal (the same values move, nothing is
computed); checksums are relative 1e-12 in f64 and 1e-5 in f32 (block
norms sum in another order than XLA's); multiplies relative to max |C|
1e-12 in f64.
"""

import numpy as np
import pytest

from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.core.matrix import BlockSparseMatrix as JaxMatrix
from dbcsr_tpu.mm.multiply import multiply as jax_multiply
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.ops import transformations as jax_tr
from dbcsr_tpu.perf import driver as jax_driver

from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.interop import matrix_from_numpy_state, matrix_to_numpy_state
from dbcsr_tpu_torch.mm.multiply import multiply as port_multiply
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.ops import transformations as port_tr
from dbcsr_tpu_torch.perf.driver import PerfConfig, run_perf

SIZES = np.array([2, 3, 5, 3, 4, 2])


@pytest.fixture(autouse=True)
def reset_jax_health():
    """The JAX package's runs in these tests feed its metrics, health
    model, events and telemetry store: all four are reset after every
    test, so a later file in the same worker (`tests/test_tune.py`'s
    admission checks) does not start from a DEGRADED or CRITICAL
    verdict."""
    yield
    for reset in (jax_metrics.reset, jax_health.reset, jax_events.clear, jax_timeseries.reset):
        reset()


def jax_state(m) -> dict:
    return {
        "row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
        "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype),
        "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
        "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in m.bins],
    }


def _draws(kind, dtype=np.float64, seed=11, occ=0.5):
    jm = jax_tm.make_random_matrix("R", SIZES, SIZES, dtype=dtype, occupation=occ,
                                   matrix_type=kind, rng=np.random.default_rng(seed))
    pm = port_tm.make_random_matrix("R", SIZES, SIZES, dtype=dtype, occupation=occ,
                                    matrix_type=kind, rng=np.random.default_rng(seed),
                                    device="cpu")
    return jm, pm


@pytest.fixture
def jax_stack_config():
    cfg = jax_get_config()
    prev = {"mm_driver": cfg.mm_driver, "mm_format": cfg.mm_format,
            "incremental": cfg.incremental}
    jax_set_config(mm_format="stack", incremental="off", mm_driver="xla")
    yield
    jax_set_config(**prev)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["S", "A", "H"])
def test_symmetric_draws_equal_jax(kind, dtype):
    jm, pm = _draws(kind, dtype)
    assert pm.matrix_type == jm.matrix_type == ("S" if kind == "H" else kind)
    assert np.array_equal(pm.keys, jm.keys)
    rows, cols = pm.entry_coords()
    assert np.all(rows <= cols)
    dense = port_tm.to_dense(pm)
    assert np.array_equal(dense, jax_tm.to_dense(jm))
    assert np.array_equal(dense, dense.T if kind != "A" else -dense.T)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    for pos in (False, True):
        want = jax_tm.checksum(jm, pos=pos)
        assert abs(port_tm.checksum(pm, pos=pos) - want) <= tol * abs(want)


@pytest.mark.parametrize("kind", ["S", "A"])
def test_put_and_get_fold_like_jax(kind):
    rng = np.random.default_rng(3)
    jm = JaxMatrix("F", SIZES, SIZES, matrix_type=kind)
    pm = BlockSparseMatrix("F", SIZES, SIZES, matrix_type=kind, device="cpu")
    lower = rng.standard_normal((5, 3))  # block (2, 1): rows 5, cols 3
    diag = rng.standard_normal((3, 3))
    batch = [rng.standard_normal((4, 3)), rng.standard_normal((2, 4))]  # (4, 3), (0, 4)
    for m in (jm, pm):
        m.put_block(2, 1, lower)
        m.put_block(1, 1, diag)
        m.put_blocks([4, 0], [3, 4], batch)
        m.finalize()
    assert np.array_equal(pm.keys, jm.keys)
    assert np.array_equal(port_tm.to_dense(pm), jax_tm.to_dense(jm))
    sign = -1.0 if kind == "A" else 1.0
    np.testing.assert_array_equal(pm.get_block(1, 2), sign * lower.T)
    np.testing.assert_array_equal(pm.get_block(2, 1), lower)
    np.testing.assert_array_equal(pm.get_block(2, 1, unfold=False), sign * lower.T)
    assert pm.get_block(5, 0) is None
    assert pm.get_stored_coordinates(2, 1) == jm.get_stored_coordinates(2, 1)
    with pytest.raises(ValueError):
        BlockSparseMatrix("F", SIZES, SIZES[:5], matrix_type=kind, device="cpu")


@pytest.mark.parametrize("kind", ["S", "A", "H"])
def test_desymmetrize_and_transpose_equal_jax(kind):
    jm, pm = _draws(kind, seed=21, occ=0.6)
    jd, pd = jax_tr.desymmetrize(jm), port_tr.desymmetrize(pm)
    assert pd.matrix_type == "N"
    assert np.array_equal(pd.keys, jd.keys)
    assert np.array_equal(port_tm.to_dense(pd), jax_tm.to_dense(jd))
    assert np.array_equal(port_tm.to_dense(pd), port_tm.to_dense(pm))
    jt, pt = jax_tr.new_transposed(jm), port_tr.new_transposed(pm)
    assert pt.matrix_type == "N"
    assert np.array_equal(pt.keys, jt.keys)
    assert np.array_equal(port_tm.to_dense(pt), jax_tm.to_dense(jt))


@pytest.mark.parametrize("kind", ["S", "A", "H"])
def test_numpy_state_round_trips(kind):
    jm, pm = _draws(kind, seed=31)
    from_jax = matrix_from_numpy_state(jax_state(jm), "cpu")
    assert from_jax.matrix_type == jm.matrix_type
    assert np.array_equal(port_tm.to_dense(from_jax), jax_tm.to_dense(jm))
    state = matrix_to_numpy_state(pm)
    assert state["matrix_type"] == pm.matrix_type
    back = matrix_from_numpy_state(state, "cpu")
    assert np.array_equal(back.keys, pm.keys)
    assert np.array_equal(port_tm.to_dense(back), port_tm.to_dense(pm))
    assert back.pattern_fingerprint() == pm.pattern_fingerprint()
    # a state of a real hermitian matrix comes back symmetric
    state["matrix_type"] = "H"
    assert matrix_from_numpy_state(state, "cpu").matrix_type == "S"
    # a symmetric kind stores its upper triangle only
    lower = matrix_to_numpy_state(port_tr.desymmetrize(pm))
    lower["matrix_type"] = "S"
    with pytest.raises(ValueError, match="upper triangle"):
        matrix_from_numpy_state(lower, "cpu")


CASES = [
    # (kind of A, kind of B, kind of C, transa, beta, filtered)
    ("S", "N", "N", "N", 0.0, False),
    ("N", "A", "N", "T", 0.5, False),
    ("S", "S", "S", "N", 1.0, False),
    ("S", "S", "S", "T", 0.0, True),
    ("A", "A", "S", "N", 0.0, False),
]


@pytest.mark.parametrize("ka,kb,kc,ta,beta,filtered", CASES)
def test_symmetric_multiply_matches_jax(ka, kb, kc, ta, beta, filtered, jax_stack_config):
    rng_j, rng_p = np.random.default_rng(41), np.random.default_rng(41)
    mats = []
    for name, kind, occ in (("A", ka, 0.6), ("B", kb, 0.6), ("C", kc, 0.3)):
        jm = jax_tm.make_random_matrix(name, SIZES, SIZES, occupation=occ, matrix_type=kind,
                                       rng=rng_j)
        pm = port_tm.make_random_matrix(name, SIZES, SIZES, occupation=occ, matrix_type=kind,
                                        rng=rng_p, device="cpu")
        mats.append((jm, pm))
    (ja, pa), (jb, pb), (jc, pc) = mats
    eps = 0.5 if filtered else None
    jflops = jax_multiply(ta, "N", 0.7, ja, jb, beta, jc, filter_eps=eps)
    pflops = port_multiply(ta, "N", 0.7, pa, pb, beta, pc, filter_eps=eps)
    assert pflops == jflops
    assert pc.matrix_type == jc.matrix_type == kc
    assert np.array_equal(pc.keys, jc.keys)
    rows, cols = pc.entry_coords()
    if kc != "N":
        assert np.all(rows <= cols)
    want = jax_tm.to_dense(jc)
    got = port_tm.to_dense(pc)
    assert np.max(np.abs(got - want)) <= 1e-12 * max(np.max(np.abs(want)), 1.0)


def test_symmetric_operand_aliasing_c(jax_stack_config):
    """C aliasing a symmetric A: the copy keeps A's fingerprint."""
    jm, pm = _draws("S", seed=51, occ=0.5)
    fp = pm.pattern_fingerprint()
    assert pm.copy().pattern_fingerprint() == fp
    jc = JaxMatrix("C", SIZES, SIZES, matrix_type="S")
    pc = BlockSparseMatrix("C", SIZES, SIZES, matrix_type="S", device="cpu")
    jax_multiply("N", "N", 1.0, jm, jm, 0.0, jc)
    port_multiply("N", "N", 1.0, pm, pm, 0.0, pc)
    jax_multiply("N", "N", 1.0, jc, jm, 0.0, jc)
    port_multiply("N", "N", 1.0, pc, pm, 0.0, pc)
    assert np.array_equal(pc.keys, jc.keys)
    np.testing.assert_allclose(port_tm.to_dense(pc), jax_tm.to_dense(jc),
                               rtol=1e-12, atol=1e-12)
    assert pm.pattern_fingerprint() == fp


@pytest.mark.parametrize("symm", [("S", "N", "N"), ("N", "S", "S"), ("A", "S", "N")])
def test_run_perf_with_symmetric_flags_matches_jax(symm, jax_stack_config):
    kw = dict(m=30, n=30, k=30, sparsity_a=0.4, sparsity_b=0.4, sparsity_c=0.6,
              symm_a=symm[0], symm_b=symm[1], symm_c=symm[2], beta=0.5, nrep=2,
              m_sizes=[(1, 4), (1, 6)], n_sizes=[(1, 4), (1, 6)], k_sizes=[(1, 4), (1, 6)])
    port = run_perf(PerfConfig(**kw), verbose=False, device="cpu")
    jax = jax_driver.run_perf(jax_driver.PerfConfig(**kw), verbose=False, n_devices=1)
    assert port["plan_cache"] == ["miss", "hit"]
    for key in ("checksum_a", "checksum_b", "checksum_c_in", "checksum", "checksum_pos"):
        assert abs(port[key] - jax[key]) <= 1e-12 * abs(jax[key]), key
