"""The port's public surface (`import dbcsr_tpu_torch`) held against the
JAX package's on the CPU.

The cases of `tests/test_api_parity.py` and of `tests/test_ops_extra.py`
(triu, crop, verify_matrix, dist_bin, function_of_elements' padding)
but the mesh ones (`replicate_all` waits for the port's distributed
engine), each run in both packages on the same operands (drawn by the
JAX package from one numpy seed and carried across), plus:

* export parity: every name of `dbcsr_tpu/__init__.py` but
  ``replicate_all`` is in `dbcsr_tpu_torch`, constants with the same
  values;
* `scale_by_vector`, `hadamard_product`, `column_norms`, `submatrix`,
  `redistribute`, `BlockIterator` and `create` against the JAX
  package's;
* `run_tests` with ``TEST_MM`` in both packages, the same checksums.

Tolerance: relative 1e-12 at f64 and 1e-6 at f32 (against the largest
magnitude, or 1); patterns equal.
"""

import io

import numpy as np
import pytest
import torch

import dbcsr_tpu as jdt
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries

import dbcsr_tpu_torch as pdt
from dbcsr_tpu_torch import device as port_device
from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.ops import test_methods as port_tm

SIZES = np.array([2, 3, 5, 3, 4])
RTOL = {np.float64: 1e-12, np.float32: 1e-6}


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
def on_cpu():
    port_device.set_default_device("cpu")
    yield
    port_device.set_default_device("cuda")


def jax_state(m) -> dict:
    return {"row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
            "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype),
            "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
            "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in m.bins]}


def pair(seed, rows=SIZES, cols=SIZES, occ=0.5, dtype=np.float64, kind="N"):
    jm = jdt.make_random_matrix("M", rows, cols, dtype=dtype, occupation=occ,
                                matrix_type=kind, rng=np.random.default_rng(seed))
    return jm, matrix_from_numpy_state(jax_state(jm), "cpu", name="M")


def assert_same(pm, jm, dtype=np.float64):
    assert pm.matrix_type == jm.matrix_type
    assert np.array_equal(pm.keys, jm.keys)
    want = np.asarray(jdt.to_dense(jm)).astype(np.complex128)
    got = pdt.to_dense(pm).astype(np.complex128)
    assert np.max(np.abs(got - want), initial=0.0) <= RTOL[dtype] * max(
        np.max(np.abs(want), initial=0.0), 1.0)


def assert_close(got, want, dtype=np.float64):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want), initial=0.0) <= RTOL[dtype] * max(
        np.max(np.abs(want), initial=0.0), 1.0)


# ---------------------------------------------------------- export parity
def test_exports_every_name_of_the_jax_package_but_replicate_all():
    waiting = set()  # replicate_all came with the distributed engine (parallel/)
    missing = [n for n in jdt.__all__ if n not in waiting and not hasattr(pdt, n)]
    assert not missing
    assert set(pdt.__all__) == set(jdt.__all__) - waiting
    for name in jdt.__all__:
        if name.startswith(("FUNC_", "TEST_", "CSR_", "dbcsr_type_")):
            assert getattr(pdt, name) == getattr(jdt, name), name


# -------------------------------------------------------------- set/clear
@pytest.mark.parametrize("value", [2.5, 0.0])
def test_set_value_keeps_pattern(value):
    jm, pm = pair(1)
    keys = pm.keys.copy()
    jdt.set_value(jm, value)
    pdt.set_value(pm, value)
    assert np.array_equal(pm.keys, keys)
    assert_same(pm, jm)
    assert np.count_nonzero(pdt.to_dense(pm)) == (pm.nnz if value else 0)


def test_clear_removes_all_blocks():
    jm, pm = pair(3, occ=0.8)
    dist = pm.dist
    jdt.clear(jm)
    pdt.clear(pm)
    assert pm.nblks == jm.nblks == 0 and pm.valid and pm.dist is dist
    pm.put_block(0, 0, np.ones((2, 2)))
    pm.finalize()
    assert pm.nblks == 1


# ------------------------------------------------------------- block diag
@pytest.mark.parametrize("kind", ["N", "S"])
def test_get_block_diag(kind):
    jm, pm = pair(4, occ=0.9, kind=kind)
    jd, pd = jdt.get_block_diag(jm), pdt.get_block_diag(pm)
    assert_same(pd, jd)
    rows, cols = pd.entry_coords()
    assert np.all(rows == cols) and pm.nblks == jm.nblks  # the original untouched


# ----------------------------------------------------- copy_into_existing
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_copy_into_existing_semantics(dtype):
    ja, pa = pair(5, dtype=dtype)
    jb, pb = pair(6, dtype=dtype)
    keys = pb.keys.copy()
    jdt.copy_into_existing(jb, ja)
    pdt.copy_into_existing(pb, pa)
    assert np.array_equal(pb.keys, keys)  # B's pattern kept
    assert_same(pb, jb, dtype)
    for r, c, blk in pb.iterate_blocks():
        src = pa.get_block(r, c)
        np.testing.assert_array_equal(blk, 0.0 if src is None else src)


def test_copy_into_existing_into_itself_and_mismatches():
    _, pm = pair(7)
    before = pdt.to_dense(pm)
    pdt.copy_into_existing(pm, pm)
    np.testing.assert_array_equal(pdt.to_dense(pm), before)
    _, other = pair(8, rows=[3, 2, 5, 3, 4])
    with pytest.raises(ValueError):
        pdt.copy_into_existing(other, pm)
    _, sym = pair(9, kind="S")
    with pytest.raises(ValueError):
        pdt.copy_into_existing(sym, pm)


# ---------------------------------------------------------------- reserve
def test_reserve_blocks_preserves_and_creates():
    m = pdt.create("m", [2, 3], [3, 2])
    m.put_block(0, 0, np.full((2, 3), 7.0))
    m.finalize()
    pdt.reserve_blocks(m, [0, 1], [0, 1])
    assert m.nblks == 2
    np.testing.assert_array_equal(m.get_block(0, 0), 7.0)
    np.testing.assert_array_equal(m.get_block(1, 1), 0.0)


@pytest.mark.parametrize("kind", ["N", "S"])
def test_reserve_diag_and_all(kind):
    sizes = [2, 3, 4]
    jm = jdt.create("m", sizes, sizes, matrix_type=kind)
    pm = pdt.create("m", sizes, sizes, matrix_type=kind)
    jdt.reserve_diag_blocks(jm)
    pdt.reserve_diag_blocks(pm)
    assert np.array_equal(pm.keys, jm.keys) and pm.nblks == 3
    jdt.reserve_all_blocks(jm)
    pdt.reserve_all_blocks(pm)
    assert np.array_equal(pm.keys, jm.keys) and pm.nblks == (9 if kind == "N" else 6)
    assert_same(pm, jm)


# ------------------------------------------------------------ named funcs
NAMED = [("FUNC_TANH", 0.1, 2.0), ("FUNC_DTANH", 0.1, 2.0), ("FUNC_DDTANH", 0.0, 1.0),
         ("FUNC_SIN", 0.2, 1.5), ("FUNC_COS", 0.2, 1.5), ("FUNC_DSIN", 0.2, 1.5),
         ("FUNC_DDSIN", 0.2, 1.5), ("FUNC_TRUNCATE", 0.5, 1.0),
         ("FUNC_SPREAD_FROM_ZERO", 0.5, 1.0), ("FUNC_INVERSE", 0.1, 2.0),
         ("FUNC_INVERSE_SPECIAL", 0.3, 1.0)]


def _named_want(fn, x, a0, a1):
    """The reference's formulas (`dbcsr_operations.F:821-960`) in NumPy."""
    return {"FUNC_TANH": lambda: np.tanh(a1 * x + a0),
            "FUNC_DTANH": lambda: a1 * (1 - np.tanh(a1 * x + a0) ** 2),
            "FUNC_DDTANH": lambda: 2.0 * a1 ** 2 * (np.tanh(a1 * x + a0) ** 3
                                                    - np.tanh(a1 * x + a0)),
            "FUNC_SIN": lambda: np.sin(a1 * x + a0), "FUNC_COS": lambda: np.cos(a1 * x + a0),
            "FUNC_DSIN": lambda: a1 * np.cos(a1 * x + a0),
            "FUNC_DDSIN": lambda: -a1 ** 2 * np.sin(a1 * x + a0),
            "FUNC_TRUNCATE": lambda: np.where(np.abs(x) > a0, np.copysign(a0, x), x),
            "FUNC_SPREAD_FROM_ZERO": lambda: np.where(np.abs(x) < a0, np.copysign(a0, x), x),
            "FUNC_INVERSE": lambda: 1.0 / (a1 * x + a0),
            "FUNC_INVERSE_SPECIAL": lambda: 1.0 / (x + np.copysign(a0, x))}[fn]()


@pytest.mark.parametrize("fn,a0,a1", NAMED)
def test_named_funcs_values(fn, a0, a1):
    """f64 against the JAX package and the formula (1e-12); f32 against
    the formula on the f32 inputs (1e-6)."""
    jm, pm = pair(10, occ=1.0)
    x = pdt.to_dense(pm)
    p32 = matrix_from_numpy_state(jax_state(jdt.make_random_matrix(
        "M", SIZES, SIZES, dtype=np.float32, occupation=1.0, rng=np.random.default_rng(10))),
        "cpu")
    x32 = pdt.to_dense(p32).astype(np.float64)
    jdt.function_of_elements(jm, getattr(jdt, fn), a0=a0, a1=a1)
    for m in (pm, p32):
        pdt.function_of_elements(m, getattr(pdt, fn), a0=a0, a1=a1)
    assert_same(pm, jm)
    np.testing.assert_allclose(pdt.to_dense(pm), _named_want(fn, x, a0, a1),
                               rtol=1e-12, atol=1e-12)
    want32 = _named_want(fn, x32, a0, a1)
    assert_close(pdt.to_dense(p32).astype(np.float64), want32, np.float32)


def test_named_funcs_positional_parameters_and_scaled_domain():
    jm = jdt.create("m", [2], [2])
    jm.put_block(0, 0, np.array([[0.2, -0.3], [0.1, 0.4]]))
    jm.finalize()
    pm = matrix_from_numpy_state(jax_state(jm), "cpu")
    for fn in ("FUNC_ARTANH", "FUNC_ASIN"):
        jx, px = jm.copy(), pm.copy()
        jdt.function_of_elements(jx, getattr(jdt, fn), 0.1, 1.5)
        pdt.function_of_elements(px, getattr(pdt, fn), 0.1, 1.5)
        assert_same(px, jx)
    with pytest.raises(TypeError):
        pdt.function_of_elements(pm.copy(), pdt.FUNC_SIN, 1, 2, 3, 4)
    with pytest.raises(ValueError):
        pdt.function_of_elements(pm.copy(), "no such function")


def test_named_funcs_domain_errors():
    """The JAX package's domain aborts, raised before any block changes."""
    m = pdt.create("m", [2], [2])
    m.put_block(0, 0, np.array([[0.5, 2.0], [0.1, 0.4]]))  # |2.0| >= 1
    m.finalize()
    for fn in (pdt.FUNC_ARTANH, pdt.FUNC_ASIN):
        x = m.copy()
        with pytest.raises(FloatingPointError):
            pdt.function_of_elements(x, fn)
        np.testing.assert_array_equal(pdt.to_dense(x), pdt.to_dense(m))
    z = pdt.create("z", [2], [2])
    z.put_block(0, 0, np.zeros((2, 2)))
    z.finalize()
    with pytest.raises(FloatingPointError):
        pdt.function_of_elements(z, pdt.FUNC_INVERSE)  # 1/0
    c = pdt.create("c", [2], [2], dtype=torch.complex128)
    c.put_block(0, 0, np.ones((2, 2), np.complex128))
    c.finalize()
    with pytest.raises(TypeError):
        pdt.function_of_elements(c, pdt.FUNC_SIN)


def test_named_funcs_callable():
    jm, pm = pair(11, occ=1.0)
    x = pdt.to_dense(pm).copy()
    pdt.function_of_elements(pm, torch.exp)
    np.testing.assert_allclose(pdt.to_dense(pm), np.where(x != 0, np.exp(x), 0.0),
                               rtol=1e-12)
    pdt.function_of_elements(pm, lambda d, s: d * s, 2.0)  # extra args pass through


def test_function_of_elements_keeps_pad_rows_zero():
    """fn(0) != 0 must not reach rows beyond a bin's count: the port's bins
    hold none, so the products after it equal the JAX package's."""
    rng = np.random.default_rng(5)
    ja = jdt.make_random_matrix("A", [4, 4, 4], [4, 4, 4], occupation=0.7,
                                dtype=np.float32, rng=rng)
    jb = jdt.make_random_matrix("B", [4, 4, 4], [4, 4, 4], occupation=0.7,
                                dtype=np.float32, rng=rng)
    pa = matrix_from_numpy_state(jax_state(ja), "cpu")
    pb = matrix_from_numpy_state(jax_state(jb), "cpu")
    for jm, pm in ((ja, pa), (jb, pb)):
        jdt.function_of_elements(jm, lambda d: d + 1.0)
        pdt.function_of_elements(pm, lambda d: d + 1.0)
        assert all(b.data.shape[0] == b.count for b in pm.bins)
    jc = jdt.create("C", [4, 4, 4], [4, 4, 4], dtype=np.float32)
    pc = pdt.create("C", [4, 4, 4], [4, 4, 4], dtype=torch.float32)
    jdt.multiply("N", "N", 1.0, ja, jb, 0.0, jc)
    pdt.multiply("N", "N", 1.0, pa, pb, 0.0, pc)
    assert_same(pc, jc, np.float32)


# -------------------------------------------------------- scale by vector
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("side", ["right", "left"])
def test_scale_by_vector(side, dtype):
    jm, pm = pair(12, rows=[2, 3, 4], cols=[3, 5], dtype=dtype)
    n = pm.nfullcols if side == "right" else pm.nfullrows
    v = np.random.default_rng(1).standard_normal(n)
    jdt.scale_by_vector(jm, v, side=side)
    pdt.scale_by_vector(pm, v, side=side)
    assert_same(pm, jm, dtype)
    with pytest.raises(ValueError):
        pdt.scale_by_vector(pm, v[:-1], side=side)
    with pytest.raises(ValueError):
        pdt.scale_by_vector(pair(13, kind="S")[1], np.ones(17))


# --------------------------------------------------------------- hadamard
@pytest.mark.parametrize("kinds", [("N", "N"), ("S", "N"), ("S", "A")])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_hadamard_product(kinds, dtype):
    ja, pa = pair(14, dtype=dtype, kind=kinds[0], occ=0.7)
    jb, pb = pair(15, dtype=dtype, kind=kinds[1], occ=0.7)
    jc, pc = jdt.hadamard_product(ja, jb), pdt.hadamard_product(pa, pb)
    assert pc.matrix_type == "N" and pc.nblks > 0
    assert_same(pc, jc, dtype)


# ------------------------------------------------------------ column norms
@pytest.mark.parametrize("kind", ["N", "S"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
def test_column_norms(kind, dtype):
    jm, pm = pair(16, dtype=dtype, kind=kind if dtype != np.complex128 else "N")
    rtol = RTOL[np.float32 if dtype == np.float32 else np.float64]
    want = np.asarray(jdt.column_norms(jm))
    np.testing.assert_allclose(pdt.column_norms(pm), want, rtol=rtol, atol=rtol)


# ------------------------------------------------------------------- triu
@pytest.mark.parametrize("kind", ["N", "S"])
def test_triu_matches_the_jax_package(kind):
    jm, pm = pair(17, occ=0.8, kind=kind)
    epoch = pm.mutation_epoch
    jdt.triu(jm)
    pdt.triu(pm)
    assert pm.mutation_epoch > epoch
    pdt.verify_matrix(pm)
    assert_same(pm, jm)
    dense = pdt.to_dense(pm)
    roff = pm.row_blk_offsets
    for r in range(pm.nblkrows):
        d = dense[roff[r]: roff[r + 1], roff[r]: roff[r + 1]]
        np.testing.assert_array_equal(d, np.triu(d))


def test_crop_matrix_element_bounds():
    jm, pm = pair(18, occ=0.8)
    bounds = ((4, pm.nfullrows - 3), (2, pm.nfullcols - 5))
    assert_same(pdt.crop_matrix(pm, *bounds), jdt.crop_matrix(jm, *bounds))
    assert_same(pdt.crop_matrix(pm), jdt.crop_matrix(jm))


def test_verify_matrix_catches_corruption():
    _, pm = pair(19)
    assert pdt.verify_matrix(pm)
    bad = pm.copy()
    bad.keys = bad.keys[::-1].copy()
    with pytest.raises(ValueError, match="sorted"):
        pdt.verify_matrix(bad)
    bad = pm.copy()
    bad.bins[0].data[0, 0, 0] = float("nan")
    with pytest.raises(ValueError, match="non-finite"):
        pdt.verify_matrix(bad)
    pdt.verify_matrix(bad, check_data=False)
    bad = pm.copy()
    bad.ent_slot = np.zeros_like(bad.ent_slot)
    with pytest.raises(ValueError, match="slot"):
        pdt.verify_matrix(bad)


# ------------------------------------------------------------------ dist
def test_dist_bin_balanced_and_as_the_jax_package():
    sizes = np.random.default_rng(0).integers(1, 50, 200)
    bins = pdt.dist_bin(200, 7, element_sizes=sizes)
    np.testing.assert_array_equal(bins, jdt.dist_bin(200, 7, element_sizes=sizes))
    loads = np.bincount(bins, weights=sizes, minlength=7)
    assert loads.max() - loads.min() <= sizes.max()
    np.testing.assert_array_equal(pdt.dist_bin(100, 5, rng=np.random.default_rng(1)),
                                  jdt.dist_bin(100, 5, rng=np.random.default_rng(1)))
    with pytest.raises(ValueError):
        pdt.dist_bin(3, 2, element_sizes=[1, 2])


def test_offsets_sizes_converters():
    off = pdt.convert_sizes_to_offsets([2, 3, 4])
    np.testing.assert_array_equal(off, [0, 2, 5, 9])
    np.testing.assert_array_equal(pdt.convert_offsets_to_sizes(off), [2, 3, 4])
    from dbcsr_tpu.core import dist as jax_dist
    from dbcsr_tpu_torch.core import dist as port_dist

    np.testing.assert_array_equal(port_dist.random_dist(9, 4, seed=3),
                                  jax_dist.random_dist(9, 4, seed=3))
    np.testing.assert_array_equal(port_dist.cyclic_dist(9, 4), jax_dist.cyclic_dist(9, 4))


def test_distribution_get_info_and_checksum():
    d = pdt.Distribution([0, 1, 0], [1, 0], pdt.ProcessGrid(2, 2))
    info = d.get_info()
    assert info["nblkrows"] == 3 and info["npcols"] == 2
    np.testing.assert_array_equal(info["row_dist"], [0, 1, 0])
    ref = jdt.Distribution([0, 1, 0], [1, 0], jdt.ProcessGrid(2, 2))
    assert d.checksum() == ref.checksum()
    assert d.checksum() != d.transposed().checksum()


# --------------------------------------------------------- info, config
def test_get_info_and_setname():
    _, m = pair(20, rows=[2, 3], cols=[4, 1], occ=0.9)
    info = m.get_info()
    assert (info["nblkrows_total"], info["nfullrows_total"], info["nfullcols_total"]) == (2, 5, 5)
    assert info["nblks"] == m.nblks and info["nze"] == m.nnz and info["data_size"] >= m.nnz
    m.setname("renamed")
    assert m.name == "renamed" and m.valid_index


def test_default_and_printed_config():
    assert pdt.get_default_config().mm_driver == "auto"
    assert pdt.get_default_config() is not pdt.get_config()
    lines = []
    pdt.print_config(out=lines.append)
    assert any("mm_driver" in ln for ln in lines) and len(lines) > 10


def test_block_iterator_and_create():
    jm, pm = pair(21)
    it, jit = pdt.BlockIterator(pm), jdt.BlockIterator(jm)
    while jit.blocks_left():
        assert it.blocks_left()
        (r, c, blk), (jr, jc, jblk) = it.next_block(), jit.next_block()
        assert (r, c) == (jr, jc)
        np.testing.assert_array_equal(blk, np.asarray(jblk))
    assert not it.blocks_left()
    with pytest.raises(IndexError):
        it.next_block()
    it = pm.iterator()
    it.stop()
    assert not it.blocks_left()
    m = pdt.create("c", [2, 3], [3], dtype=torch.float32, matrix_type="N")
    assert m.dtype == torch.float32 and m.device.type == "cpu" and m.nblks == 0


# -------------------------------------------------- submatrix/redistribute
@pytest.mark.parametrize("kind", ["N", "S"])
def test_submatrix(kind):
    jm, pm = pair(22, occ=0.8, kind=kind)
    js, ps = jdt.submatrix(jm, 1, 4, 2, 5), pdt.submatrix(pm, 1, 4, 2, 5)
    assert (ps.nblkrows, ps.nblkcols) == (3, 3)
    assert_same(ps, js)


def test_redistribute():
    _, pm = pair(23)
    d = pdt.Distribution(np.arange(5) % 2, np.zeros(5, np.int32), pdt.ProcessGrid(2, 1))
    out = pdt.redistribute(pm, d, name="R")
    assert out.dist is d and out.name == "R"
    np.testing.assert_array_equal(pdt.to_dense(out), pdt.to_dense(pm))
    with pytest.raises(ValueError):
        pdt.redistribute(pm, pdt.Distribution([0], [0]))


# ------------------------------------------------------------------ prints
def test_print_matrix_and_block_sum():
    jm, pm = pair(24, rows=[2, 3], cols=[3, 2], occ=1.0)
    buf, jbuf = io.StringIO(), io.StringIO()
    pdt.print_matrix(pm, file=buf)
    jdt.print_matrix(jm, file=jbuf)
    assert buf.getvalue() == jbuf.getvalue()
    buf, jbuf = io.StringIO(), io.StringIO()
    pdt.print_block_sum(pm, file=buf)
    jdt.print_block_sum(jm, file=jbuf)
    lines, jlines = buf.getvalue().splitlines(), jbuf.getvalue().splitlines()
    assert len(lines) == pm.nblks == len(jlines)
    for ln, jln in zip(lines, jlines):
        assert ln.split()[:2] == jln.split()[:2]
        assert abs(float(ln.split()[2]) - float(jln.split()[2])) <= 1e-12 * max(
            1.0, abs(float(jln.split()[2])))


# --------------------------------------------------------------- run_tests
def test_run_tests_mm_as_the_jax_package():
    out = []
    cs = pdt.run_tests((48, 36, 52), sparsities=(0.4, 0.4, 0.4), alpha=1.5, beta=0.5,
                       n_loops=2, io=out.append)
    ref = jdt.run_tests((48, 36, 52), sparsities=(0.4, 0.4, 0.4), alpha=1.5, beta=0.5,
                        n_loops=2, io=lambda *_: None)
    assert len(cs) == 2 and cs[0] == cs[1] and out
    assert abs(cs[0] - ref[0]) <= 1e-12 * abs(ref[0])


@pytest.mark.parametrize("data_type", [1, 5])
def test_run_tests_mm_transposed_retain(data_type):
    cs = pdt.run_tests((30, 30, 40), trs=(True, True), sparsities=(0.3, 0.3, 0.5),
                       retain_sparsity=True, data_type=data_type, n_loops=1,
                       io=lambda *_: None)
    assert len(cs) == 1


def test_run_tests_binary_io():
    cs = pdt.run_tests((30, 30, 30), test_type=pdt.TEST_BINARY_IO, n_loops=2,
                       io=lambda *_: None)
    ref = jdt.run_tests((30, 30, 30), test_type=jdt.TEST_BINARY_IO, n_loops=2,
                        io=lambda *_: None)
    assert len(cs) == 2 and abs(cs[0] - ref[0]) <= 1e-12 * abs(ref[0])


def test_run_tests_reports_a_wrong_product(monkeypatch):
    from dbcsr_tpu_torch.ops import tests as port_tests

    real = port_tests.multiply

    def wrong(*args, **kwargs):
        out = real(*args, **kwargs)
        pdt.scale(args[6], 1.01)
        return out

    monkeypatch.setattr(port_tests, "multiply", wrong)
    with pytest.raises(port_tests.TestFailure, match="dense oracle"):
        pdt.run_tests((20, 20, 20), io=lambda *_: None)
    with pytest.raises(ValueError):
        pdt.run_tests((20, 20, 20), test_type=9, io=lambda *_: None)


def test_make_random_block_sizes_as_the_jax_package():
    from dbcsr_tpu.ops.tests import make_random_block_sizes as jax_sizes
    from dbcsr_tpu_torch.ops.tests import make_random_block_sizes

    sizes = make_random_block_sizes(100, (1, 13, 2, 5), rng=np.random.default_rng(0))
    assert sizes.sum() == 100
    np.testing.assert_array_equal(sizes, jax_sizes(100, (1, 13, 2, 5),
                                                   rng=np.random.default_rng(0)))
    with pytest.raises(ValueError):
        make_random_block_sizes(10, (1, 2, 3))


def test_reset_randmat_seed_reproduces():
    pdt.reset_randmat_seed(7)
    m1 = pdt.make_random_matrix("x", [3, 3], [3, 3], occupation=0.7)
    pdt.reset_randmat_seed(7)
    m2 = pdt.make_random_matrix("x", [3, 3], [3, 3], occupation=0.7)
    jdt.reset_randmat_seed(7)
    m3 = jdt.make_random_matrix("x", [3, 3], [3, 3], occupation=0.7)
    assert pdt.checksum(m1) == pdt.checksum(m2)
    assert abs(pdt.checksum(m1) - jdt.checksum(m3)) <= 1e-12 * abs(jdt.checksum(m3))
    port_tm.reset_randmat_seed()


def test_impose_sparsity_as_the_jax_package():
    from dbcsr_tpu.ops.test_methods import impose_sparsity as jax_impose

    jm, pm = pair(25, kind="S", occ=0.4)
    dense = np.random.default_rng(2).standard_normal((pm.nfullrows, pm.nfullcols))
    np.testing.assert_array_equal(port_tm.impose_sparsity(dense, pm), jax_impose(dense, jm))


def test_remaining_export_surface():
    assert pdt.dtype_of(pdt.dbcsr_type_real_8) == torch.float64
    assert pdt.dtype_of(pdt.dbcsr_type_complex_4) == torch.complex64
    csr = pdt.CsrMatrix(2, 2, [0, 1, 2], [0, 1], np.array([1.0, 2.0]))
    assert csr.nze == 2 and csr.valid
    assert pdt.TEST_MM == 1 and pdt.TEST_BINARY_IO == 2
    pdt.finalize_lib()
    pdt.init_lib()
    with pdt.chain():
        m = pdt.make_random_matrix("x", [3], [3], occupation=1.0,
                                   rng=np.random.default_rng(0))
        assert pdt.trace(m) == pytest.approx(float(np.trace(pdt.to_dense(m))))
