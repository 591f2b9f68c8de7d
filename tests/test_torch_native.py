"""The port's native host index engine (`dbcsr_tpu_torch/native/`) on the
CPU, built here with g++ at first use.

Its symbolic product must give the same arrays, in the same order, as
the port's NumPy path and as the JAX package's engine and NumPy path, on
identical operands (JAX matrices carried across with
`dbcsr_tpu_torch.interop`): with each of the six block limits, the norm
filter (a NaN norm product included), and the symmetric-C skip.  Its
stack sort must equal `np.lexsort` and the JAX package's `sort_order`,
multi-group sorts included.  A multiply gives C bit for bit under both
engines, and `read_totals` names the engine that ran.  All comparisons
are exact.
"""

import os

import numpy as np
import pytest

from dbcsr_tpu import native as jax_native
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.core.matrix import create as jax_create
from dbcsr_tpu.mm.multiply import _candidates_numpy as jax_candidates_numpy
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries

from dbcsr_tpu_torch import native
from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.mm import multiply as mm


@pytest.fixture(autouse=True)
def reset_jax_health():
    """The JAX products of these tests feed the JAX package's metrics,
    health model and telemetry store (their first compiles read as a
    recompile storm, their samples as a burning roofline objective): a
    later file in the same process must not inherit a DEGRADED verdict."""
    yield
    for reset in (jax_metrics.reset, jax_health.reset, jax_timeseries.reset):
        reset()


MIXED = np.array([2, 3, 5, 3, 4, 2, 3, 5, 2, 4])


def jax_state(m) -> dict:
    return {
        "row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
        "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype),
        "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
        "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in m.bins],
    }


def pairs(seed, sizes=MIXED, occ=0.4):
    """(JAX, port) A and B from one numpy-seeded draw, and an empty JAX C."""
    rng = np.random.default_rng(seed)
    out = []
    for name in "AB":
        jm = jax_tm.make_random_matrix(name, sizes, sizes, occupation=occ, rng=rng)
        out += [jm, matrix_from_numpy_state(jax_state(jm), "cpu", name=name)]
    return (*out, jax_create("C", sizes, sizes).finalize())


def assert_same(*results):
    first = results[0]
    for other in results[1:]:
        assert len(other) == len(first) == 4
        for x, y in zip(first, other):
            assert np.array_equal(np.asarray(x, np.int64), np.asarray(y, np.int64))


def expansions(ja, pa, jb, pb, jc, norms=(None, None, None), sym_c=False, limits=(None,) * 6):
    """The port's engine, the port's NumPy path, the JAX package's NumPy
    path and (when it builds) the JAX package's engine."""
    cols_a, cols_b = pa.keys % pa.nblkcols, pb.keys % pb.nblkcols
    got = native.symbolic_product(pa.row_ptr, cols_a, pb.row_ptr, cols_b, *norms,
                                  sym_c=sym_c, limits=limits)
    mine = mm._candidates_numpy(pa, pb, *norms, sym_c, limits)
    theirs = jax_candidates_numpy(ja, jb, jc, *norms, *limits) if not sym_c else mine
    out = [got, mine, theirs]
    if jax_native.get_lib() is not None:
        fr, lr, fc, lc, fk, lk = limits
        out.append(jax_native.symbolic_product(
            ja.row_ptr, cols_a.astype(np.int32), jb.row_ptr, cols_b.astype(np.int32), *norms,
            sym_c=sym_c, fr=fr, lr=lr, fc=fc, lc=lc, fk=fk, lk=lk))
    return out


def test_engine_builds_into_the_build_directory():
    lib = native.get_lib()
    assert lib.dbcsr_native_version() == 2
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert native.build_seconds is not None


LIMITS = [
    (None,) * 6,
    (2, 7, None, None, None, None),      # rows
    (None, None, 1, 4, None, None),      # columns
    (None, None, None, None, 3, 8),      # k
    (1, 8, 2, 9, 0, 6),                  # all six
    (None, 5, 4, None, 2, None),         # one side each
    (6, 6, 6, 6, 6, 6),                  # one block
]


@pytest.mark.parametrize("limits", LIMITS)
def test_expansion_matches_numpy_and_jax(limits):
    ja, pa, jb, pb, jc = pairs(0)
    results = expansions(ja, pa, jb, pb, jc, limits=limits)
    assert_same(*results)
    if limits == (None,) * 6:
        assert len(results[0][0]) > 100


def test_expansion_with_norm_filter():
    ja, pa, jb, pb, jc = pairs(1, occ=0.6)
    na2 = pa.block_norms().astype(np.float32) ** 2
    nb2 = pb.block_norms().astype(np.float32) ** 2
    row_eps = np.full(pa.nblkrows, np.float32(np.median(na2) * np.median(nb2)), np.float32)
    results = expansions(ja, pa, jb, pb, jc, norms=(na2, nb2, row_eps))
    assert_same(*results)
    unfiltered = native.symbolic_product(pa.row_ptr, pa.keys % pa.nblkcols, pb.row_ptr,
                                         pb.keys % pb.nblkcols)
    assert 0 < len(results[0][0]) < len(unfiltered[0])  # the filter dropped some


def test_expansion_nan_norm_product_drops():
    """inf (an overflowed f32 norm^2) * 0 (a zero block) is NaN: every
    path drops the candidate."""
    ja, pa, jb, pb, jc = pairs(2, occ=0.8)
    na2 = np.full(pa.nblks, np.float32(np.inf), np.float32)
    nb2 = np.zeros(pb.nblks, np.float32)
    nb2[::2] = 1.0  # half the products are inf, half NaN
    row_eps = np.full(pa.nblkrows, np.float32(1e-6), np.float32)
    results = expansions(ja, pa, jb, pb, jc, norms=(na2, nb2, row_eps))
    assert_same(*results)
    assert np.all(results[0][3] % 2 == 0)  # only the inf products survive


def test_expansion_symmetric_skip_with_limits():
    ja, pa, jb, pb, jc = pairs(3, occ=0.7)
    for limits in ((None,) * 6, (1, 7, 2, 8, None, None)):
        got, mine, *_ = expansions(ja, pa, jb, pb, jc, sym_c=True, limits=limits)
        assert_same(got, mine)
        assert (got[0] <= got[1]).all()
    want = jax_native.symbolic_product(ja.row_ptr, (ja.keys % ja.nblkcols).astype(np.int32),
                                       jb.row_ptr, (jb.keys % jb.nblkcols).astype(np.int32),
                                       sym_c=True)
    if want is not None:
        assert_same(native.symbolic_product(pa.row_ptr, pa.keys % pa.nblkcols, pb.row_ptr,
                                            pb.keys % pb.nblkcols, sym_c=True), want)


@pytest.mark.parametrize("ngroups,n,slots,a_order", [
    (1, 3000, 40, "random"), (12, 5000, 40, "random"), (64, 20000, 40, "random"),
    # groups of 2^16 entries and more, sorted on every thread
    (1, 200000, 50000, "random"), (3, 300000, 30000, "ascending"),
    # a slot range far wider than the entries: the comparison sort
    (2, 4000, 10**7, "random")])
def test_sort_matches_lexsort_and_jax(ngroups, n, slots, a_order):
    rng = np.random.default_rng(ngroups)
    g = rng.integers(0, ngroups, n).astype(np.int64)
    c_slot = rng.integers(0, slots, n).astype(np.int32)
    a_ent = (np.arange(n) if a_order == "ascending" else rng.permutation(n)).astype(np.int64)
    order, bounds = native.group_sort_stacks(g, ngroups, c_slot, a_ent)
    assert np.array_equal(order, np.lexsort((a_ent, c_slot, g)))
    j_order, j_bounds = jax_native.sort_order(g, ngroups, c_slot, a_ent, return_bounds=True)
    assert np.array_equal(order, j_order) and np.array_equal(bounds, j_bounds)
    assert np.array_equal(bounds, np.concatenate([[0], np.cumsum(np.bincount(g, minlength=ngroups))]))


def test_sort_rejects_group_ids_out_of_range():
    with pytest.raises(ValueError):
        native.group_sort_stacks(np.array([0, 3]), 3, np.zeros(2, np.int32), np.arange(2))
    with pytest.raises(ValueError):
        native.symbolic_product([0, 1], [5], [0, 1], [0])  # A's column past B's rows


def test_multiply_is_bitwise_the_same_under_both_engines(monkeypatch):
    """Mixed blocking, so the stacks form many groups; a filtered and an
    unfiltered product, each under the engine and the NumPy path."""
    rng = np.random.default_rng(4)
    ja, pa, jb, pb, _ = pairs(5, occ=0.5)
    pc = matrix_from_numpy_state(jax_state(jax_tm.make_random_matrix(
        "C", MIXED, MIXED, occupation=0.3, rng=rng)), "cpu", name="C")
    results = {}
    for engine in ("1", "0"):
        monkeypatch.setenv("DBCSR_TPU_TORCH_NATIVE", engine)
        mm.clear_plan_cache()
        mm.reset_totals()
        for eps in (None, 0.5):
            c = pc.copy()
            mm.multiply("N", "N", 0.7, pa, pb, 0.5, c, filter_eps=eps)
            results[engine, eps] = c
            assert len(c._mm_spans) > 4
        kind = "native" if engine == "1" else "numpy"
        other = "numpy" if engine == "1" else "native"
        totals = mm.read_totals()["index_engine"]
        assert totals == {"expand": {kind: 2, other: 0}, "sort": {kind: 2, other: 0},
                          "coo_fill": {kind: 0, other: 0}, "union": {"bitmap": 2, "sort": 0}}
    for eps in (None, 0.5):
        x, y = results["1", eps], results["0", eps]
        assert np.array_equal(x.keys, y.keys)
        for bx, by in zip(x.bins, y.bins):
            assert bx.data.equal(by.data)


def test_numpy_path_needs_no_compiler(monkeypatch, tmp_path):
    """A failed build raises; the NumPy path, asked for, never builds."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path", lambda: str(tmp_path / "libnone.so"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    ja, pa, jb, pb, _ = pairs(6)
    c = mm.BlockSparseMatrix("C", MIXED, MIXED, device="cpu")
    with pytest.raises(RuntimeError, match="not found"):
        mm.multiply("N", "N", 1.0, pa, pb, 0.0, c.copy())
    monkeypatch.setenv("DBCSR_TPU_TORCH_NATIVE", "0")
    mm.multiply("N", "N", 1.0, pa, pb, 0.0, c)
    assert c.nblks > 0 and native._lib is None
