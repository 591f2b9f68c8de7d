"""The port's matrix operations held against the JAX package's on the CPU.

Operands are drawn by the JAX package from one numpy seed and carried
across with `dbcsr_tpu_torch.interop`, so both packages start from the
same values.  Tolerance: relative 1e-13 in f64 and 1e-6 in f32 (each
result against its max magnitude, or 1); patterns must be equal.
"""

import numpy as np
import pytest

from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.ops import operations as jops
from dbcsr_tpu.ops import test_methods as jax_tm

from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.ops import operations as pops
from dbcsr_tpu_torch.ops import test_methods as port_tm

SIZES = np.array([2, 3, 5, 3, 4])
RTOL = {np.float64: 1e-13, np.float32: 1e-6}


def jax_state(m) -> dict:
    return {
        "row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
        "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype),
        "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
        "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in m.bins],
    }


def pair(seed, kind="N", dtype=np.float64, occ=0.5, rows=SIZES, cols=SIZES):
    jm = jax_tm.make_random_matrix("M", rows, cols, dtype=dtype, occupation=occ,
                                   matrix_type=kind, rng=np.random.default_rng(seed))
    return jm, matrix_from_numpy_state(jax_state(jm), "cpu", name="M")


def assert_same(pm, jm, dtype=np.float64):
    assert pm.matrix_type == jm.matrix_type
    assert np.array_equal(pm.keys, jm.keys)
    want = jax_tm.to_dense(jm).astype(np.float64)
    got = port_tm.to_dense(pm).astype(np.float64)
    assert np.max(np.abs(got - want), initial=0.0) <= RTOL[dtype] * max(
        np.max(np.abs(want), initial=0.0), 1.0)


def assert_close(got, want, dtype=np.float64):
    assert abs(got - want) <= RTOL[dtype] * max(abs(want), 1.0), (got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_filter_matrix(dtype):
    jm, pm = pair(1, dtype=dtype)
    eps = float(np.median(pm.block_norms()))
    jops.filter_matrix(jm, eps)
    pops.filter_matrix(pm, eps)
    assert 0 < pm.nblks
    assert_same(pm, jm, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["N", "S"])
def test_scale(kind, dtype):
    jm, pm = pair(2, kind, dtype)
    jops.scale(jm, -0.37)
    pops.scale(pm, -0.37)
    assert_same(pm, jm, dtype)


ADD_CASES = {
    # (seed of B relative to A's pattern: "same" or a fresh draw, kind)
    "same_pattern": ("same", "N"),
    "union": ("fresh", "N"),
    "symmetric_union": ("fresh", "S"),
    "antisymmetric_same": ("same", "A"),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(ADD_CASES))
def test_add_and_added(case, dtype):
    how, kind = ADD_CASES[case]
    ja, pa = pair(3, kind, dtype)
    if how == "same":
        jb, pb = ja.copy("B"), pa.copy("B")
        jops.scale(jb, 0.25)
        pops.scale(pb, 0.25)
    else:
        jb, pb = pair(4, kind, dtype, occ=0.4)
    jsum = jops.added(ja, jb, 1.5, -0.5)
    psum = pops.added(pa, pb, 1.5, -0.5)
    assert_same(psum, jsum, dtype)
    assert_same(pa, ja, dtype)  # operands untouched
    assert_same(pb, jb, dtype)
    jops.add(ja, jb, 1.5, -0.5)
    pops.add(pa, pb, 1.5, -0.5)
    assert_same(pa, ja, dtype)
    assert np.array_equal(port_tm.to_dense(pa), port_tm.to_dense(psum))


def test_add_mixed_symmetry_raises_as_in_jax():
    ja, pa = pair(5, "S")
    jb, pb = pair(6, "N")
    with pytest.raises(ValueError, match="mixed symmetry"):
        jops.add(ja, jb)
    with pytest.raises(ValueError, match="mixed symmetry"):
        pops.add(pa, pb)
    with pytest.raises(ValueError, match="mixed symmetry"):
        pops.added(pa, pb)


def test_add_to_itself():
    ja, pa = pair(7)
    jops.add(ja, ja, 2.0, 1.0)
    pops.add(pa, pa, 2.0, 1.0)
    assert_same(pa, ja)


def test_copy_set_value_clear():
    ja, pa = pair(8, "S")
    jc, pc = jops.copy(ja, "C"), pops.copy(pa, "C")
    jops.set_value(jc, 0.75)
    pops.set_value(pc, 0.75)
    assert_same(pc, jc)
    assert_same(pa, ja)  # the copy owns its data
    assert pc.pattern_fingerprint() == pa.pattern_fingerprint()
    jops.clear(jc)
    pops.clear(pc)
    assert pc.nblks == jc.nblks == 0 and pc.valid and pc.matrix_type == "S"
    assert np.array_equal(port_tm.to_dense(pc), jax_tm.to_dense(jc))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["N", "S", "A"])
def test_reductions(kind, dtype):
    jm, pm = pair(9, kind, dtype, occ=0.7)
    for name in ("trace", "frobenius_norm", "maxabs_norm", "gershgorin_norm"):
        assert_close(getattr(pops, name)(pm), getattr(jops, name)(jm), dtype)


@pytest.mark.parametrize("kinds", [("N", "N"), ("S", "S"), ("A", "A"), ("S", "N")])
def test_dot(kinds):
    ja, pa = pair(10, kinds[0], occ=0.6)
    jb, pb = pair(11, kinds[1], occ=0.6)
    assert_close(pops.dot(pa, pb), jops.dot(ja, jb))


@pytest.mark.parametrize("shape", ["square", "wide"])
def test_diagonal_access(shape):
    # wide: the diagonal blocks straddle the short edge
    cols = SIZES if shape == "square" else np.array([3, 3, 4, 2, 3, 1])
    rng = np.random.default_rng(12)
    ja, pa = pair(12, occ=0.6, cols=cols)
    np.testing.assert_allclose(pops.get_diag(pa), jops.get_diag(ja), rtol=0, atol=0)
    vals = rng.standard_normal(min(pa.nfullrows, pa.nfullcols))
    jops.set_diag(ja, vals)
    pops.set_diag(pa, vals)
    assert_same(pa, ja)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["N", "S"])
def test_add_on_diag_creates_missing_blocks(kind, dtype):
    jm, pm = pair(13, kind, dtype, occ=0.3)
    rows, cols = pm.entry_coords()
    assert (rows == cols).sum() < pm.nblkrows  # some diagonal blocks missing
    jops.add_on_diag(jm, 0.8)
    pops.add_on_diag(pm, 0.8)
    rows, cols = pm.entry_coords()
    assert (rows == cols).sum() == pm.nblkrows
    assert_same(pm, jm, dtype)
    before = pm.keys
    pops.add_on_diag(pm, -0.3)  # every diagonal block present: no restructure
    jops.add_on_diag(jm, -0.3)
    assert pm.keys is before
    assert_same(pm, jm, dtype)


def test_add_on_diag_needs_square_diagonal_blocks():
    _, pm = pair(14, cols=np.array([3, 3, 4, 2, 3]))
    with pytest.raises(ValueError, match="square"):
        pops.add_on_diag(pm, 1.0)
