"""The one structure move of the port, `BlockSparseMatrix.bins_onto`,
held against the JAX package on the CPU.

`bins_onto` moves a matrix onto a larger key set: fresh zero bins laid
out by `_bin_entries`, each old block moved to its new slot, scaled by a
factor inside an optional element window.  Both C's rebuild in the
multiply (`mm/multiply.py:_rebuild_c`) and `finalize`'s merge
(`core/matrix.py:_merge_staged`) call it.  The same numpy-seeded
operands (JAX matrices carried across with `dbcsr_tpu_torch.interop`)
go through the JAX package's `_rebuild_c`, `multiply` and `finalize`
and through the port's, in f64 and complex128.

Tolerances: keys, bin ids and slots equal; a move, which scales each
value by one factor, and a finalize's values bit for bit; a multiply's
values within 1e-12 of max |C| (the products sum in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.mm.multiply import _rebuild_c as jax_rebuild_c
from dbcsr_tpu.mm.multiply import multiply as jax_multiply
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries
from dbcsr_tpu.ops import test_methods as jax_tm

from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.ops import test_methods as port_tm

ROWS = [2, 3, 2, 4, 3]  # element offsets 0, 2, 5, 7, 11; 14 rows
COLS = [3, 2, 4, 2]  # 0, 3, 5, 9; 11 columns
INNER = [2, 3, 3]
DTYPES = [np.float64, np.complex128]
FACTORS = [None, 0.0, 1.0, 0.5, -2.0]
WINDOWS = {
    "none": None,
    "covering": (0, sum(ROWS) - 1, 0, sum(COLS) - 1),
    # rows 1-8 cut block rows 0 and 3, columns 2-7 block columns 0 and 2
    "straddling": (1, 8, 2, 7),
}


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
def stack_config():
    """Both packages on the stack format, where C is rebuilt, without the
    incremental cache."""
    keys = ("mm_format", "incremental")
    jprev = {k: getattr(jax_get_config(), k) for k in keys}
    pprev = {k: getattr(get_config(), k) for k in keys}
    jax_set_config(mm_format="stack", incremental="off", mm_driver="xla")
    set_config(mm_format="stack", incremental="off")
    mm.clear_plan_cache()
    mm.reset_totals()
    yield
    jax_set_config(**jprev)
    set_config(**pprev)
    mm.clear_plan_cache()


def jax_state(m) -> dict:
    return {
        "row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
        "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype),
        "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
        "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in m.bins],
    }


def draw(name, rows, cols, dtype, occ, seed):
    """A (JAX, port) pair of one random matrix."""
    jm = jax_tm.make_random_matrix(name, rows, cols, dtype=dtype, occupation=occ,
                                   rng=np.random.default_rng(seed))
    return jm, matrix_from_numpy_state(jax_state(jm), "cpu", name=name)


def assert_same_structure(pm: BlockSparseMatrix, jm) -> None:
    assert np.array_equal(pm.keys, jm.keys)
    assert np.array_equal(pm.ent_bin, jm.ent_bin)
    assert np.array_equal(pm.ent_slot, jm.ent_slot)
    assert [b.shape for b in pm.bins] == [tuple(b.shape) for b in jm.bins]
    assert [b.count for b in pm.bins] == [b.count for b in jm.bins]


def block_bytes(m, keys) -> np.ndarray:
    r, c = keys // m.nblkcols, keys % m.nblkcols
    return m.row_blk_sizes[r].astype(np.int64) * m.col_blk_sizes[c] * m.dtype.itemsize


def wholly_inside(m, window) -> np.ndarray:
    """Which of ``m``'s blocks lie wholly inside the element window."""
    if window is None:
        return np.ones(m.nblks, bool)
    r0, r1, c0, c1 = window
    rows, cols = m.entry_coords()
    roff, coff = m.row_blk_offsets, m.col_blk_offsets
    return ((roff[rows] >= r0) & (roff[rows + 1] - 1 <= r1)
            & (coff[cols] >= c0) & (coff[cols + 1] - 1 <= c1))


# ------------------------------------------------------------ the move
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "c128"])
@pytest.mark.parametrize("window", list(WINDOWS), ids=list(WINDOWS))
@pytest.mark.parametrize("factor", FACTORS, ids=[str(f) for f in FACTORS])
def test_bins_onto_moves_as_the_jax_rebuild_does(factor, window, dtype):
    jm, pm = draw("C", ROWS, COLS, dtype, 0.5, seed=11)
    grown = np.random.default_rng(12).choice(pm.nblkrows * pm.nblkcols, 6)
    new_keys = np.union1d(pm.keys, grown)
    assert len(new_keys) > pm.nblks
    old_keys, old_ptrs = pm.keys.copy(), {b.data.untyped_storage().data_ptr() for b in pm.bins}
    inside = wholly_inside(pm, WINDOWS[window])
    bins, binning, allocated, moved = pm.bins_onto(new_keys, factor, WINDOWS[window])
    # nothing is installed until the caller does
    assert np.array_equal(pm.keys, old_keys)
    assert all(b.data.untyped_storage().data_ptr() not in old_ptrs for b in bins)
    assert allocated == int(block_bytes(pm, new_keys).sum())
    moved_bytes = block_bytes(pm, old_keys)
    assert moved == int(moved_bytes[~inside].sum() if factor == 0 else moved_bytes.sum())
    pm.set_structure_from_device(new_keys, bins, binning=binning)
    jax_rebuild_c(jm, new_keys, 1.0 if factor is None else factor,
                  beta_window=WINDOWS[window])
    assert_same_structure(pm, jm)
    assert np.array_equal(port_tm.to_dense(pm), jax_tm.to_dense(jm))


def test_bins_onto_counts_the_bytes_of_one_fixed_case():
    """3x3 blocks of 2x2 f64 (32 bytes a block): C's two diagonal blocks
    moved onto five keys allocate 160 bytes and move 64; at factor 0
    they move nothing, and inside a window that holds only block (0, 0)
    the other one moves as it is."""
    c = BlockSparseMatrix("C", [2, 2, 2], [2, 2, 2], device="cpu")
    c.put_blocks([0, 1], [0, 1], np.ones((2, 2, 2)))
    c.finalize()
    keys = np.array([0, 1, 4, 5, 6])
    assert c.bins_onto(keys, 0.5)[2:] == (160, 64)
    assert c.bins_onto(keys, 0.0)[2:] == (160, 0)
    assert c.bins_onto(keys, 0.0, (0, 1, 0, 1))[2:] == (160, 32)
    a = BlockSparseMatrix("A", [2, 2, 2], [2, 2, 2], device="cpu")
    a.put_blocks([0, 1, 2], [0, 1, 2], np.ones((3, 2, 2)))
    b = BlockSparseMatrix("B", [2, 2, 2], [2, 2, 2], device="cpu")
    b.put_blocks([0, 1, 2], [1, 2, 0], np.ones((3, 2, 2)))
    for m in (a, b):
        m.finalize()
    mm.multiply("N", "N", 1.0, a, b, 0.5, c)
    assert np.array_equal(c.keys, keys)
    assert mm.read_totals()["rebuild_bytes"] == {"allocated": 160, "moved": 64}


# ------------------------------------------------------------ multiply
MULTIPLY_WINDOWS = {
    "none": {},
    # block limits over all of C: beta scales inside a window that
    # holds every block
    "covering": dict(first_row=0, last_row=len(ROWS) - 1, first_col=0,
                     last_col=len(COLS) - 1),
    "straddling": dict(element_limits=WINDOWS["straddling"] + (None, None)),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "c128"])
@pytest.mark.parametrize("window", list(MULTIPLY_WINDOWS), ids=list(MULTIPLY_WINDOWS))
@pytest.mark.parametrize("beta", FACTORS[1:], ids=[str(f) for f in FACTORS[1:]])
def test_multiply_rebuilds_c_as_the_jax_package_does(beta, window, dtype):
    (ja, pa), (jb, pb), (jc, pc) = (draw(n, r, c, dtype, occ, seed=20 + i) for i, (n, r, c, occ)
                                    in enumerate((("A", ROWS, INNER, 0.5),
                                                  ("B", INNER, COLS, 0.5),
                                                  ("C", ROWS, COLS, 0.4))))
    kw = MULTIPLY_WINDOWS[window]
    jflops = jax_multiply("N", "N", 1.25, ja, jb, beta, jc, **kw)
    pflops = mm.multiply("N", "N", 1.25, pa, pb, beta, pc, **kw)
    assert pflops == jflops
    assert pc._mm_algorithm == "stack"
    assert mm.read_totals()["c_rebuild"]["rebuilt"] == 1
    assert_same_structure(pc, jc)
    got, want = port_tm.to_dense(pc), jax_tm.to_dense(jc)
    assert np.max(np.abs(got - want)) <= 1e-12 * max(np.max(np.abs(want)), 1.0)


# ------------------------------------------------------------ finalize
def stage(jm, pm, rows, cols, blocks, how, summation):
    if how == "put_blocks":
        jm.put_blocks(rows, cols, blocks, summation=summation)
        pm.put_blocks(rows, cols, blocks, summation=summation)
    else:
        jm.stage_device_blocks(rows, cols, jnp.asarray(blocks), summation=summation)
        pm.stage_device_blocks(rows, cols, torch.from_numpy(blocks), summation=summation)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "c128"])
@pytest.mark.parametrize("summation", [False, True], ids=["replace", "sum"])
@pytest.mark.parametrize("pattern", ["same", "growing"])
@pytest.mark.parametrize("how", ["put_blocks", "stage_device_blocks"])
def test_finalize_merges_as_the_jax_package_does(how, pattern, summation, dtype):
    jm, pm = draw("A", ROWS, COLS, dtype, 0.5, seed=31)
    rng = np.random.default_rng(32)
    # one batch of one shape (a device batch has one), (3, 2) blocks:
    # block rows 1 and 4, block columns 1 and 3
    shaped = [(r, c) for r in (1, 4) for c in (1, 3)]
    held = [rc for rc in shaped if pm._find_entry(*rc) >= 0]
    free = [rc for rc in shaped if pm._find_entry(*rc) < 0]
    assert held and free
    coords = held + (free if pattern == "growing" else [])
    rows, cols = (np.array(x, np.int64) for x in zip(*coords))
    blocks = rng.standard_normal((len(rows), 3, 2)).astype(dtype)
    if dtype == np.complex128:
        blocks = blocks + 1j * rng.standard_normal(blocks.shape)
    e0, old_ptrs = pm.mutation_epoch, {b.data.untyped_storage().data_ptr() for b in pm.bins}
    je0 = jm.mutation_epoch
    stage(jm, pm, rows, cols, blocks, how, summation)
    jm.finalize()
    pm.finalize()
    assert_same_structure(pm, jm)
    assert np.array_equal(port_tm.to_dense(pm), jax_tm.to_dense(jm))
    assert all(b.data.untyped_storage().data_ptr() not in old_ptrs for b in pm.bins)
    # a same-pattern finalize journals exactly the staged keys
    dirty, jdirty = pm.dirty_keys_since(e0), jm.dirty_keys_since(je0)
    if pattern == "same":
        assert np.array_equal(dirty, np.sort(rows * pm.nblkcols + cols))
        assert np.array_equal(dirty, jdirty)
    else:
        assert dirty is None and jdirty is None
