"""The port's tall-and-skinny (TAS) multiply held against the JAX package
on the CPU.

The cases of `tests/test_tas.py` and the TAS cases of
`tests/test_tensor.py`, after
`dbcsr_tas_unittest.F:48-100`: the same numpy-seeded operands (JAX
matrices carried across with `dbcsr_tpu_torch.interop`) go through both
packages' `tas_multiply`, where the port's K1 wrapper runs its plain
version on the CPU tensors; the JAX package runs its "xla" driver.  The
mesh cases run the JAX package on its forced 8-device CPU mesh and the
port on a grid of CPU images.

Tolerances: C's pattern equal to the JAX package's; C relative to max
|C| within 1e-12 of it (f64) or within `kernel_validation_tolerance`
(f32), and within 1e-12 (f64) of the dense oracle.
"""

import numpy as np
import pytest
import torch

from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.tas import batched_mm as jax_batched_mm
from dbcsr_tpu.tas import tas_multiply as jax_tas_multiply

from dbcsr_tpu_torch.core import timings
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.matrix import SYMMETRIC, BlockSparseMatrix
from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.mm import multiply as port_mm
from dbcsr_tpu_torch.mm.multiply import multiply as port_multiply
from dbcsr_tpu_torch.obs.costmodel import kernel_validation_tolerance
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.ops.operations import scale
from dbcsr_tpu_torch.tas import (
    TASMatrix,
    batched_mm,
    batched_mm_finalize,
    batched_mm_init,
    choose_nsplit,
    choose_nsplit_traffic,
    estimate_split_factor,
    estimate_split_traffic,
    tas_multiply,
)
from dbcsr_tpu_torch.tas import split as port_split


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


@pytest.fixture(autouse=True)
def jax_xla_config():
    cfg = jax_get_config()
    prev = {"mm_driver": cfg.mm_driver, "mm_format": cfg.mm_format,
            "incremental": cfg.incremental}
    jax_set_config(mm_format="stack", incremental="off", mm_driver="xla")
    yield
    jax_set_config(**prev)


def jax_state(m) -> dict:
    return {
        "row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
        "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype),
        "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
        "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in m.bins],
    }


def _pair(name, rows, cols, occ, rng, dtype=np.float64):
    jm = jax_tm.make_random_matrix(name, rows, cols, dtype=dtype, occupation=occ, rng=rng)
    return jm, matrix_from_numpy_state(jax_state(jm), "cpu", name=name)


def _tall(nlong, nshort, seed):
    rng = np.random.default_rng(seed)
    long_sizes = rng.integers(2, 6, nlong).astype(np.int32)
    short_sizes = rng.integers(2, 6, nshort).astype(np.int32)
    return long_sizes, short_sizes, rng


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want), initial=0.0)) / max(float(np.max(np.abs(want),
                                                                           initial=0.0)), 1.0)


def _agree(pc, jc, oracle=None, tol=1e-12):
    """The port's C against the JAX package's (pattern and values) and,
    when given, against the dense oracle."""
    assert np.array_equal(pc.keys, jc.keys)
    got = port_tm.to_dense(pc).astype(np.float64)
    assert _rel(got, jax_tm.to_dense(jc).astype(np.float64)) <= tol
    if oracle is not None:
        assert _rel(got, oracle) <= tol


@pytest.mark.parametrize("transa,transb", [("N", "N"), ("T", "N"), ("N", "T"), ("T", "T")])
def test_tas_multiply_transposes(transa, transb):
    """Tall A (m long), small B; all transpose combos, nsplit 4."""
    ls, ss, rng = _tall(30, 4, seed=1)
    a_shape = (ls, ss) if transa == "N" else (ss, ls)
    ja, pa = _pair("a", *a_shape, 0.3, rng)
    jb, pb = _pair("b", ss, ss, 0.6, rng)
    jc, pc = _pair("c", ls, ss, 0.0, rng)
    jf = jax_tas_multiply(transa, transb, 1.0, ja, jb, 0.0, jc, nsplit=4)
    pf = tas_multiply(transa, transb, 1.0, pa, pb, 0.0, pc, nsplit=4)
    assert pf == jf and pc._tas_nsplit == 4
    da = jax_tm.to_dense(ja) if transa == "N" else jax_tm.to_dense(ja).T
    db = jax_tm.to_dense(jb) if transb == "N" else jax_tm.to_dense(jb).T
    _agree(pc, jc, da @ db)


def test_tas_k_split_inner_product():
    """A^T B with k long (two tall matrices) splits over k and sums."""
    ls, ss, rng = _tall(40, 3, seed=2)
    ja, pa = _pair("a", ls, ss, 0.4, rng)
    jb, pb = _pair("b", ls, ss, 0.4, rng)
    jc, pc = _pair("c", ss, ss, 0.0, rng)
    jax_tas_multiply("T", "N", 1.0, ja, jb, 0.0, jc, nsplit=5)
    tas_multiply("T", "N", 1.0, pa, pb, 0.0, pc, nsplit=5)
    _agree(pc, jc, jax_tm.to_dense(ja).T @ jax_tm.to_dense(jb))


def test_tas_n_long_splits_columns():
    """A wide C (n long) splits its block columns."""
    ls, ss, rng = _tall(36, 3, seed=12)
    ja, pa = _pair("a", ss, ss, 0.8, rng)
    jb, pb = _pair("b", ss, ls, 0.4, rng)
    jc, pc = _pair("c", ss, ls, 0.3, rng)
    c0 = jax_tm.to_dense(jc)
    jax_tas_multiply("N", "N", 1.5, ja, jb, 0.5, jc, nsplit=6)
    tas_multiply("N", "N", 1.5, pa, pb, 0.5, pc, nsplit=6)
    _agree(pc, jc, 1.5 * jax_tm.to_dense(ja) @ jax_tm.to_dense(jb) + 0.5 * c0)


def test_tas_beta_accumulate():
    ls, ss, rng = _tall(20, 3, seed=3)
    ja, pa = _pair("a", ls, ss, 0.5, rng)
    jb, pb = _pair("b", ss, ss, 0.8, rng)
    jc, pc = _pair("c", ls, ss, 0.3, rng)
    c0 = jax_tm.to_dense(jc)
    jax_tas_multiply("N", "N", 2.0, ja, jb, 0.5, jc, nsplit=3)
    tas_multiply("N", "N", 2.0, pa, pb, 0.5, pc, nsplit=3)
    _agree(pc, jc, 2.0 * jax_tm.to_dense(ja) @ jax_tm.to_dense(jb) + 0.5 * c0)


def _long_operands(long_dim, seed, c_occ):
    """JAX and port operands of an m-, n- or k-long product (trans flags
    first), C at occupancy ``c_occ``."""
    ls, ss, rng = _tall(25, 4, seed=seed)
    a_shape, b_shape, c_shape, trans = {
        "m": ((ls, ss), (ss, ss), (ls, ss), ("N", "N")),
        "n": ((ss, ss), (ss, ls), (ss, ls), ("N", "N")),
        "k": ((ls, ss), (ls, ss), (ss, ss), ("T", "N"))}[long_dim]
    ja, pa = _pair("a", *a_shape, 0.4, rng)
    jb, pb = _pair("b", *b_shape, 0.7, rng)
    jc, pc = _pair("c", *c_shape, c_occ, rng)
    return trans, (ja, jb, jc), (pa, pb, pc)


def _group_loop(transa, transb, alpha, a, b, beta, c, nsplit, long_dim):
    """The split as it ran before C was pre-built: C scaled by beta, then
    one multiply at beta 1 per group, each restructuring C."""
    if beta != 1.0:
        scale(c, beta)
    nblk, lo, hi = {"m": (c.nblkrows, "first_row", "last_row"),
                    "n": (c.nblkcols, "first_col", "last_col"),
                    "k": (a.nblkrows if transa == "T" else a.nblkcols, "first_k",
                          "last_k")}[long_dim]
    per = -(-nblk // nsplit)
    for g0 in range(0, nblk, per):
        port_multiply(transa, transb, alpha, a, b, 1.0, c,
                      **{lo: g0, hi: min(g0 + per, nblk) - 1})


@pytest.mark.parametrize("beta", [0.0, 1.0, 0.5])
@pytest.mark.parametrize("long_dim", ["m", "n", "k"])
def test_tas_matches_single_multiply(long_dim, beta):
    """nsplit > 1 gives one multiply's keys, and bit for bit the values of
    the group loop that restructured C in every group.  An m- or n-long
    split also gives one multiply's values bit for bit (each C block sums
    its products in the same order, in one group); a k-long split adds
    each group's partial sums to C in turn, so there the JAX package's
    split is the reference, within 1e-12."""
    (ta, tb), (ja, jb, jc), (pa, pb, pc1) = _long_operands(long_dim, 4, 0.3)
    pc2, pc3 = pc1.copy(), pc1.copy()
    port_multiply(ta, tb, 1.5, pa, pb, beta, pc1)
    tas_multiply(ta, tb, 1.5, pa, pb, beta, pc2, nsplit=6)
    _group_loop(ta, tb, 1.5, pa, pb, beta, pc3, 6, long_dim)
    jax_tas_multiply(ta, tb, 1.5, ja, jb, beta, jc, nsplit=6)
    assert pc2._tas_nsplit == 6
    assert np.array_equal(pc1.keys, pc2.keys) and np.array_equal(pc3.keys, pc2.keys)
    assert np.array_equal(port_tm.to_dense(pc3), port_tm.to_dense(pc2))
    if long_dim != "k":
        assert np.array_equal(port_tm.to_dense(pc1), port_tm.to_dense(pc2))
    _agree(pc2, jc)


@pytest.mark.parametrize("long_dim,sym", [("m", "b"), ("n", "a"), ("k", "c"), ("k", "")])
def test_tas_prebuilt_keys_are_the_groups_union(long_dim, sym):
    """`final_keys` is C's keys and the union of every group's
    candidates, with symmetric operands desymmetrized and a symmetric
    C's stored triangle."""
    (ta, tb), _, (pa, pb, pc) = _long_operands(long_dim, 9, 0.2)
    rng = np.random.default_rng(9)
    ops = {"a": pa, "b": pb, "c": pc}
    if sym:
        x = ops[sym]
        ops[sym] = port_tm.make_random_matrix(sym, x.row_blk_sizes, x.col_blk_sizes,
                                              occupation=0.5, matrix_type=SYMMETRIC,
                                              rng=rng, device="cpu")
    pa, pb, pc = ops["a"], ops["b"], ops["c"]
    a, b = port_mm._effective(pa, ta), port_mm._effective(pb, tb)
    nblk, lo, hi = {"m": (pc.nblkrows, 0, 1), "n": (pc.nblkcols, 2, 3),
                    "k": (a.nblkcols, 4, 5)}[long_dim]
    want = pc.keys
    for g0 in range(0, nblk, 3):
        limits = [None] * 6
        limits[lo], limits[hi] = g0, min(g0 + 3, nblk) - 1
        i, j, _, _ = port_mm._candidates(a, b, None, sym_c=sym == "c", limits=tuple(limits))
        want = np.union1d(want, i * pc.nblkcols + j)
    got = port_mm.final_keys(ta, tb, pa, pb, pc)
    assert np.array_equal(got, want) and len(got) > len(pc.keys)
    tas_multiply(ta, tb, 1.0, pa, pb, 0.5, pc, nsplit=4)
    assert np.array_equal(pc.keys, want)


def test_tas_wrapper_and_auto_split():
    ls, ss, rng = _tall(50, 3, seed=5)
    ja, pa = _pair("a", ls, ss, 0.2, rng)
    jb, pb = _pair("b", ss, ss, 0.9, rng)
    jc, pc = _pair("c", ls, ss, 0.0, rng)
    a, b, c = TASMatrix(pa), TASMatrix(pb), TASMatrix(pc)
    assert a.long_dim == "rows" and b.long_dim == "rows"
    assert a.nblkrows == 50 and a.nblkcols == 3 and a.dtype == torch.float64
    assert a.row_groups(4) == [(0, 13), (13, 26), (26, 39), (39, 50)]
    assert b.col_groups(2) == [(0, 2), (2, 3)]
    jax_tas_multiply("N", "N", 1.0, ja, jb, 0.0, jc)  # auto nsplit
    tas_multiply("N", "N", 1.0, a, b, 0.0, c)
    want_split = choose_nsplit(estimate_split_factor(
        pc.nfullrows, pc.nfullcols, pa.nfullcols, pa.nnz, pb.nnz, 0), 64, 50)
    assert c.matrix._tas_nsplit == want_split > 1
    _agree(c.matrix, jc, jax_tm.to_dense(ja) @ jax_tm.to_dense(jb))


def test_tas_split_factor_knob():
    """``tas_split_factor`` scales the estimate before the split is chosen."""
    ls, ss, rng = _tall(50, 3, seed=5)
    _, pa = _pair("a", ls, ss, 0.2, rng)
    _, pb = _pair("b", ss, ss, 0.9, rng)
    splits = []
    prev = get_config().tas_split_factor
    try:
        for f in (1.0, 0.01):
            set_config(tas_split_factor=f)
            c = BlockSparseMatrix("c", ls, ss, device="cpu")
            tas_multiply("N", "N", 1.0, pa, pb, 0.0, c)
            splits.append(c._tas_nsplit)
        with pytest.raises(ValueError, match="tas_split_factor"):
            set_config(tas_split_factor=0.0)
    finally:
        set_config(tas_split_factor=prev)
    assert splits[0] > 1 and splits[1] == 1


def test_split_heuristics_are_the_jax_packages():
    from dbcsr_tpu.tas import split as jax_split

    sf = estimate_split_factor(10000, 100, 100, 10**5, 10**4, 10**5)
    assert sf > 1
    assert choose_nsplit(sf, ngroups_max=8, nblks_long=1000) <= 8
    assert choose_nsplit(0.5, 8, 10) == 1
    assert choose_nsplit(100.0, 8, 3) == 3
    for args in ((10000, 100, 100, 10**5, 10**4, 10**5), (2208**2, 2208, 2208, 529_600_000,
                                                           1_062_232, 0)):
        assert port_split.estimate_split_factor(*args) == jax_split.estimate_split_factor(*args)
    for long_dim in ("m", "n", "k"):
        for g in (1, 3, 8):
            args = (long_dim, g, 1000, 200, 500.0, 8, 2, 2)
            assert estimate_split_traffic(*args) == jax_split.estimate_split_traffic(*args)
        args = (long_dim, 400, 50, 60, 4000, 800, 0, 8, 2, 2, 64, 48)
        assert choose_nsplit_traffic(*args) == jax_split.choose_nsplit_traffic(*args)


def test_tas_batched_mm_state_machine():
    """Repeated TAS multiplies in one batch: the filter is deferred to the
    finalize and the split is kept."""
    rng = np.random.default_rng(41)
    rbs, cbs = [3] * 20, [4, 4]
    ja, pa = _pair("A", rbs, cbs, 0.7, rng)
    jb, pb = _pair("B", cbs, cbs, 1.0, rng)
    jc, pc = _pair("C", rbs, cbs, 0.0, rng)
    want = np.zeros((sum(rbs), sum(cbs)))
    with jax_batched_mm(jc):
        for _ in range(3):
            jax_tas_multiply("N", "N", 1.0, ja, jb, 1.0, jc, filter_eps=1e-12)
    with batched_mm(pc):
        state = pc._tas_batched_state
        for _ in range(3):
            tas_multiply("N", "N", 1.0, pa, pb, 1.0, pc, filter_eps=1e-12)
            want += port_tm.to_dense(pa) @ port_tm.to_dense(pb)
        assert state["filter_eps"] == 1e-12 and state["nsplit"] >= 1
    assert pc._tas_batched_state is None
    _agree(pc, jc, want, tol=1e-10)


def test_tas_batched_mm_pinned_split_and_errors():
    rng = np.random.default_rng(42)
    rbs, cbs = [3] * 12, [4, 4]
    _, pa = _pair("A", rbs, cbs, 0.7, rng)
    _, pb = _pair("B", cbs, cbs, 1.0, rng)
    _, pc = _pair("C", rbs, cbs, 0.0, rng)
    batched_mm_init(TASMatrix(pc), nsplit=2)
    with pytest.raises(RuntimeError, match="already"):
        batched_mm_init(pc)
    tas_multiply("N", "N", 1.0, pa, pb, 0.0, pc)
    assert pc._tas_nsplit == 2 and pc._tas_batched_state["nsplit_explicit"]
    batched_mm_finalize(pc)
    with pytest.raises(RuntimeError, match="not in"):
        batched_mm_finalize(pc)


def test_tas_batched_split_reoptimizes_on_sparsity_change():
    """A stale cached split leaves the acceptance window of the current
    optimum and is re-chosen once (ref `dbcsr_tas_split.F:57`)."""
    rng = np.random.default_rng(43)
    rbs, cbs = [3] * 64, [4, 4]
    ja, pa = _pair("A", rbs, cbs, 0.9, rng)
    jb, pb = _pair("B", cbs, cbs, 1.0, rng)
    jc, pc = _pair("C", rbs, cbs, 0.0, rng)
    for tas, bmm, a, b, c in ((jax_tas_multiply, jax_batched_mm, ja, jb, jc),
                              (tas_multiply, batched_mm, pa, pb, pc)):
        with bmm(c):
            state = c._tas_batched_state
            state["nsplit"] = 1
            state["nblks_checked"] = None
            tas(("N"), "N", 1.0, a, b, 1.0, c)
            assert state["nsplit"] > 1 and state["resplit_count"] == 1
            tas("N", "N", 1.0, a, b, 1.0, c)
            assert state["resplit_count"] == 1
    want = 2 * port_tm.to_dense(pa) @ port_tm.to_dense(pb)
    _agree(pc, jc, want, tol=1e-10)


def test_tas_multiply_float32_matches_jax():
    ls, ss, rng = _tall(24, 3, seed=6)
    ja, pa = _pair("a", ls, ss, 0.5, rng, np.float32)
    jb, pb = _pair("b", ss, ss, 0.8, rng, np.float32)
    jc, pc = _pair("c", ls, ss, 0.2, rng, np.float32)
    jax_tas_multiply("N", "N", 1.0, ja, jb, 0.5, jc, nsplit=4)
    tas_multiply("N", "N", 1.0, pa, pb, 0.5, pc, nsplit=4)
    assert pc.dtype == torch.float32
    _agree(pc, jc, tol=kernel_validation_tolerance("float32", int(ss.max()), len(ss)))


def test_tas_multiply_is_timed():
    ls, ss, rng = _tall(16, 3, seed=7)
    _, pa = _pair("a", ls, ss, 0.5, rng)
    _, pb = _pair("b", ss, ss, 0.8, rng)
    _, pc = _pair("c", ls, ss, 0.0, rng)
    timings.reset()
    tas_multiply("N", "N", 1.0, pa, pb, 0.0, pc, nsplit=2)
    assert timings._stats["tas_multiply"].calls == 1


def test_tas_multiply_on_a_mesh_raises():
    """A mesh that is not a `parallel` grid raises before anything runs:
    no silent single-device run for a mesh."""
    ls, ss, rng = _tall(10, 2, seed=8)
    _, pa = _pair("a", ls, ss, 0.5, rng)
    _, pb = _pair("b", ss, ss, 0.8, rng)
    _, pc = _pair("c", ls, ss, 0.0, rng)
    before = pc.nblks
    with pytest.raises(TypeError, match="Grid"):
        tas_multiply("N", "N", 1.0, pa, pb, 0.0, pc, nsplit=2, mesh=object())
    assert pc.nblks == before


# ------------------------------------------------------------- on a grid
def _grids(n, layers=None):
    from dbcsr_tpu.parallel import make_grid as jax_make_grid

    from dbcsr_tpu_torch.parallel import make_grid

    return jax_make_grid(n, layers=layers), make_grid(n, devices=["cpu"] * n, layers=layers)


def test_tas_multiply_on_mesh_matches_jax():
    """`tests/test_tas.py:91`: the grouped per-group Cannons with beta."""
    ls, ss, rng = _tall(30, 4, seed=21)
    ja, pa = _pair("a", ls, ss, 0.3, rng)
    jb, pb = _pair("b", ss, ss, 0.6, rng)
    jc, pc = _pair("c", ls, ss, 0.2, rng)
    jm, pm = _grids(8)
    want = 1.5 * jax_tm.to_dense(ja) @ jax_tm.to_dense(jb) + 0.5 * jax_tm.to_dense(jc)
    jf = jax_tas_multiply("N", "N", 1.5, ja, jb, 0.5, jc, nsplit=3, mesh=jm)
    pf = tas_multiply("N", "N", 1.5, pa, pb, 0.5, pc, nsplit=3, mesh=pm)
    assert pf == jf
    _agree(pc, jc, want)


@pytest.mark.parametrize("transa,transb", [("T", "T"), ("T", "N")])
def test_tas_multiply_on_mesh_column_and_k_long_match_jax(transa, transb):
    """Column-long C (run as C^T with row groups) and a k-long product
    (the layered sparse Cannon) on a grid."""
    ls, ss, rng = _tall(28, 3, seed=22)
    if transb == "T":
        ja, pa = _pair("a", ss, ss, 0.7, rng)
        jb, pb = _pair("b", ls, ss, 0.4, rng)
        jc, pc = _pair("c", ss, ls, 0.0, rng)
        want = jax_tm.to_dense(ja).T @ jax_tm.to_dense(jb).T
    else:
        ja, pa = _pair("a", ls, ss, 0.4, rng)
        jb, pb = _pair("b", ls, ss, 0.4, rng)
        jc, pc = _pair("c", ss, ss, 0.0, rng)
        want = jax_tm.to_dense(ja).T @ jax_tm.to_dense(jb)
    jm, pm = _grids(8)
    jax_tas_multiply(transa, transb, 1.0, ja, jb, 0.0, jc, nsplit=4, mesh=jm)
    tas_multiply(transa, transb, 1.0, pa, pb, 0.0, pc, nsplit=4, mesh=pm)
    _agree(pc, jc, want)


def test_tas_auto_split_on_rectangular_layered_grid_matches_jax():
    """`tests/test_tas.py:234`: the automatic split on a 2x1x3 grid routes
    to the layered all-gather engine."""
    ls, ss, rng = _tall(24, 4, seed=23)
    ja, pa = _pair("a", ls, ss, 0.4, rng)
    jb, pb = _pair("b", ss, ss, 0.6, rng)
    jc, pc = _pair("c", ls, ss, 0.0, rng)
    jm, pm = _grids(6, layers=2)
    jf = jax_tas_multiply("N", "N", 1.0, ja, jb, 0.0, jc, mesh=jm)
    pf = tas_multiply("N", "N", 1.0, pa, pb, 0.0, pc, mesh=pm)
    assert pf == jf
    _agree(pc, jc, jax_tm.to_dense(ja) @ jax_tm.to_dense(jb))


def test_tas_mesh_split_is_the_traffic_optimum():
    """On a square grid the automatic split is the JAX package's
    `choose_nsplit_traffic` for the same operands."""
    from dbcsr_tpu.tas.split import choose_nsplit_traffic as jax_choose_traffic

    ls, ss, rng = _tall(40, 3, seed=24)
    ja, pa = _pair("a", ls, ss, 0.3, rng)
    jb, pb = _pair("b", ss, ss, 0.8, rng)
    jc, pc = _pair("c", ls, ss, 0.0, rng)
    jm, pm = _grids(8)
    want = jax_choose_traffic("m", pc.nfullrows, pc.nfullcols, pa.nfullcols, pa.nnz, pb.nnz,
                              pc.nnz, 8, 2, 2, 64, max(pc.nblkrows, pc.nblkcols, pa.nblkcols))
    jax_tas_multiply("N", "N", 1.0, ja, jb, 0.0, jc, mesh=jm)
    tas_multiply("N", "N", 1.0, pa, pb, 0.0, pc, mesh=pm)
    assert pc._tas_nsplit == want
    _agree(pc, jc)


def test_batched_mesh_multiply_refactors_the_grid():
    """A batched multiply on a grid re-factors the images to the batch's
    split (`optimize_grid`, the batched pgrid re-optimization) and keeps
    the product right."""
    ls, ss, rng = _tall(32, 3, seed=25)
    _, pa = _pair("a", ls, ss, 0.4, rng)
    _, pb = _pair("b", ss, ss, 0.7, rng)
    _, pc = _pair("c", ls, ss, 0.0, rng)
    _, pm = _grids(8)
    batched_mm_init(pc)
    tas_multiply("N", "N", 1.0, pa, pb, 1.0, pc, nsplit=8, mesh=pm)
    state = pc._tas_batched_state
    assert dict(state["pgrid"].shape) == {"kl": 8, "pr": 1, "pc": 1}
    assert state["repgrid_count"] == 1
    batched_mm_finalize(pc)
    want = port_tm.to_dense(pa) @ port_tm.to_dense(pb)
    assert _rel(port_tm.to_dense(pc), want) <= 1e-12


def test_tas_create_places_on_the_asked_device():
    t = TASMatrix.create("T", [3, 4], [5], device="cpu", nsplit=2)
    assert t.matrix.device.type == "cpu" and t.nsplit == 2
    t.put_block(1, 0, np.ones((4, 5)))
    t.finalize()
    assert np.array_equal(t.get_block(1, 0), np.ones((4, 5)))
    assert [blk.shape for _, _, blk in t.iterate_blocks()] == [(4, 5)]
    assert "nsplit=2" in repr(t)
