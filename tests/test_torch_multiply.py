"""The port's stack-format multiply held against the JAX package's on
identical operands (numpy-seeded JAX matrices carried across with
`dbcsr_tpu_torch.interop`), its `run_perf` against the committed `.perf`
checksums and the JAX driver's choice of format, and its random
matrices against the JAX package's, all on the CPU.

The JAX side is pinned to the stack format, with the Pallas kernel in
interpret mode for f32 and the XLA stack driver for f64.  Tolerances,
relative to max |C|: f64 <= 1e-12; f32 the shared
`kernel_validation_tolerance` of the block k and the k-block count.
"""

import os

import numpy as np
import pytest
import torch

from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.mm.multiply import multiply as jax_multiply
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.perf import driver as jax_driver

from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.interop import matrix_from_numpy_state, matrix_to_numpy_state
from dbcsr_tpu_torch.mm.multiply import multiply as port_multiply
from dbcsr_tpu_torch.obs.costmodel import kernel_validation_tolerance
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.perf.driver import (
    PerfChecksumError,
    PerfConfig,
    parse_perf_file,
    run_perf,
)

INPUTS = os.path.join(os.path.dirname(__file__), "inputs")
UNIFORM = np.full(6, 23)
MIXED = np.array([5, 13, 23, 5, 13, 23, 13])


def jax_state(m) -> dict:
    """The interop state of a JAX BlockSparseMatrix (bins sliced to count)."""
    return {
        "row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
        "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype),
        "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
        "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count]))
                 for b in m.bins],
    }


def _pair(name, rows, cols, dtype, occ, rng):
    jm = jax_tm.make_random_matrix(name, rows, cols, dtype=dtype, occupation=occ, rng=rng)
    return jm, matrix_from_numpy_state(jax_state(jm), "cpu", name=name)


@pytest.fixture
def jax_stack_config():
    cfg = jax_get_config()
    prev = {"mm_driver": cfg.mm_driver, "mm_format": cfg.mm_format,
            "incremental": cfg.incremental}
    yield
    jax_set_config(**prev)


CASES = [
    # (blocking, dtype, transa, transb, beta, filter, retain_sparsity)
    ("uniform", np.float64, "N", "N", 0.0, False, False),
    ("uniform", np.float64, "T", "N", 1.0, False, False),
    ("uniform", np.float64, "N", "T", 0.5, False, False),
    ("mixed", np.float64, "T", "T", 0.5, False, False),
    ("mixed", np.float64, "N", "N", 1.0, True, False),
    ("uniform", np.float64, "N", "N", 1.0, False, True),
    ("mixed", np.float64, "N", "N", 0.0, False, True),
    ("uniform", np.float32, "N", "N", 0.5, False, False),
    ("mixed", np.float32, "T", "N", 1.0, False, False),
    ("mixed", np.float32, "N", "N", 0.0, True, False),
]


@pytest.mark.parametrize("blocking,dtype,ta,tb,beta,filtered,retain", CASES)
def test_multiply_matches_jax(blocking, dtype, ta, tb, beta, filtered, retain,
                              jax_stack_config):
    sizes = UNIFORM if blocking == "uniform" else MIXED
    kb = sizes[:5]  # the inner blocking differs from the outer ones
    rng = np.random.default_rng(2024)
    ar, ac = (sizes, kb) if ta == "N" else (kb, sizes)
    br, bc = (kb, sizes) if tb == "N" else (sizes, kb)
    ja, pa = _pair("A", ar, ac, dtype, 0.5, rng)
    jb, pb = _pair("B", br, bc, dtype, 0.5, rng)
    jc, pc = _pair("C", sizes, sizes, dtype, 0.3, rng)
    eps = None
    if filtered:
        # a threshold that keeps some C blocks and drops others
        probe = pc.copy()
        port_multiply(ta, tb, 0.7, pa, pb, 0.0, probe)
        eps = float(np.median(probe.block_norms()))
    jax_set_config(mm_format="stack", incremental="off",
                   mm_driver="xla" if dtype == np.float64 else "pallas")
    jflops = jax_multiply(ta, tb, 0.7, ja, jb, beta, jc,
                          retain_sparsity=retain, filter_eps=eps)
    pflops = port_multiply(ta, tb, 0.7, pa, pb, beta, pc,
                           retain_sparsity=retain, filter_eps=eps)
    assert pflops == jflops
    assert np.array_equal(pc.keys, jc.keys)
    if filtered:
        assert 0 < pc.nblks < probe.nblks
    if retain:
        assert pc.nblks == len(jax_state(jc)["keys"])
    want = jax_tm.to_dense(jc).astype(np.float64)
    got = port_tm.to_dense(pc).astype(np.float64)
    rel = float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1.0)
    tol = (1e-12 if dtype == np.float64
           else kernel_validation_tolerance("float32", int(kb.max()), len(kb)))
    assert rel <= tol


def test_multiply_squares_in_place(jax_stack_config):
    """C aliasing A: both packages snapshot A before restructuring C."""
    rng = np.random.default_rng(7)
    ja, pa = _pair("A", MIXED, MIXED, np.float64, 0.4, rng)
    jax_set_config(mm_format="stack", incremental="off", mm_driver="xla")
    jax_multiply("N", "N", 1.0, ja, ja, 0.0, ja)
    port_multiply("N", "N", 1.0, pa, pa, 0.0, pa)
    assert np.array_equal(pa.keys, ja.keys)
    np.testing.assert_allclose(port_tm.to_dense(pa), jax_tm.to_dense(ja),
                               rtol=1e-12, atol=1e-12)


# the runnable subset of tests/test_perf_driver.py's ported .perf inputs
# (single process grid; test_square_sparse_rma needs the device mesh)
RUNNABLE = ["test_rect1_dense", "test_rect2_dense", "test_singleblock",
            "test_square_dense", "test_square_sparse"]


@pytest.mark.parametrize("name", RUNNABLE)
def test_run_perf_reproduces_committed_checksums(name, jax_stack_config):
    """Each format the planner picks passes the gate, and it is the
    format the JAX package's planner picks for the same input."""
    cfg = parse_perf_file(os.path.join(INPUTS, f"{name}.perf"))
    cfg.nrep = 1
    res = run_perf(cfg, verbose=False, device="cpu")  # raises on mismatch
    assert res["flops"] > 0
    jax_set_config(mm_format="auto", incremental="off", mm_driver="xla")
    want = jax_driver.run_perf(jax_driver.parse_perf_file(os.path.join(INPUTS, f"{name}.perf")),
                               verbose=False, n_devices=1)
    assert res["algorithm"] == want["algorithm"]
    assert res["algorithms"] == [want["algorithm"]] * cfg.nrep
    assert res["flops"] == want["flops"]


def test_run_perf_checksum_mismatch_raises():
    cfg = parse_perf_file(os.path.join(INPUTS, "test_square_dense.perf"))
    cfg.nrep = 1
    cfg.check_refs = (cfg.check_refs[0] * 1.5, cfg.check_refs[1])
    with pytest.raises(PerfChecksumError):
        run_perf(cfg, verbose=False, device="cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("blocking", ["uniform", "mixed"])
def test_make_random_matrix_bit_equal_to_jax(dtype, blocking):
    sizes = UNIFORM if blocking == "uniform" else MIXED
    jm = jax_tm.make_random_matrix("R", sizes, sizes[:4], dtype=dtype, occupation=0.4,
                                   rng=np.random.default_rng(99))
    pm = port_tm.make_random_matrix("R", sizes, sizes[:4], dtype=dtype, occupation=0.4,
                                    rng=np.random.default_rng(99), device="cpu")
    assert np.array_equal(pm.keys, jm.keys)
    assert np.array_equal(port_tm.to_dense(pm), jax_tm.to_dense(jm))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_checksums_match_jax(dtype):
    jm = jax_tm.make_random_matrix("R", MIXED, MIXED, dtype=dtype, occupation=0.6,
                                   rng=np.random.default_rng(5))
    pm = matrix_from_numpy_state(jax_state(jm), "cpu")
    # float32 block norms sum in float32, in another order than XLA's
    tol = 1e-12 if dtype == np.float64 else 1e-5
    for pos in (False, True):
        want = jax_tm.checksum(jm, pos=pos)
        assert abs(port_tm.checksum(pm, pos=pos) - want) <= tol * abs(want)


def test_assembly_matches_jax():
    """put_block/put_blocks staging (summation, duplicates, a second
    finalize that migrates existing blocks) lands the same blocks."""
    rng = np.random.default_rng(21)
    sizes = MIXED[:5]

    def blocks(rows, cols):
        return [rng.standard_normal((sizes[r], sizes[c])) for r, c in zip(rows, cols)]

    jm = jax_tm.make_random_matrix("M", sizes, sizes, occupation=0.3,
                                   rng=np.random.default_rng(4))
    pm = matrix_from_numpy_state(jax_state(jm), "cpu")
    steps = [
        ([0, 1, 1, 4], [2, 3, 3, 0], True),
        ([2, 2, 3], [2, 2, 1], False),
        ([0, 4], [2, 4], True),
    ]
    for rows, cols, summation in steps:
        blks = blocks(rows, cols)
        for m in (jm, pm):
            m.put_blocks(rows, cols, blks, summation=summation)
            m.put_block(3, 3, np.full((sizes[3], sizes[3]), blks[0][0, 0]),
                        summation=True)
            m.finalize()
    assert np.array_equal(pm.keys, jm.keys)
    np.testing.assert_allclose(port_tm.to_dense(pm), jax_tm.to_dense(jm),
                               rtol=1e-15, atol=1e-15)
    with pytest.raises(ValueError):
        pm.put_blocks([0, 1], [0, 1], blocks([0], [0]))


def test_numpy_state_round_trip():
    pm = port_tm.make_random_matrix("R", MIXED, MIXED[:3], occupation=0.5,
                                    rng=np.random.default_rng(3), device="cpu")
    back = matrix_from_numpy_state(matrix_to_numpy_state(pm), "cpu")
    assert np.array_equal(back.keys, pm.keys)
    assert np.array_equal(port_tm.to_dense(back), port_tm.to_dense(pm))
    bad = matrix_to_numpy_state(pm)
    bad["ent_slot"] = bad["ent_slot"] + 1
    with pytest.raises(ValueError):
        matrix_from_numpy_state(bad, "cpu")


def test_unported_features_raise():
    # symmetric kinds (tests/test_torch_symmetric.py), limits
    # (tests/test_torch_limits.py) and complex kinds
    # (tests/test_torch_complex.py) are ported: a complex matrix builds, a
    # limited multiply and a limited run_perf run; a complex scalar with
    # a real C raises
    assert BlockSparseMatrix("Z", MIXED, MIXED, dtype=7, device="cpu").dtype == torch.complex128
    pm = port_tm.make_random_matrix("R", MIXED, MIXED, occupation=0.5,
                                    rng=np.random.default_rng(1), device="cpu")
    c = pm.copy()
    port_multiply("N", "N", 1.0, pm, pm, 0.0, c, first_row=1)
    d = port_tm.to_dense(pm)
    want = d @ d
    want[: MIXED[0]] = d[: MIXED[0]]  # block row 0 is outside the window: C as it was
    np.testing.assert_allclose(port_tm.to_dense(c), want, rtol=1e-12, atol=1e-12)
    with pytest.raises(TypeError):
        port_multiply("N", "N", 1.0 + 1.0j, pm, pm, 0.0, pm.copy())
    res = run_perf(PerfConfig(m=20, n=20, k=20, limits=(1, 5, 0, 0, 0, 0)),
                   verbose=False, device="cpu")
    assert res["algorithm"] == "stack" and res["flops"] > 0


def test_bf16_matrix_rounds_like_jax():
    """bf16 blocks staged in float32 and rounded on upload equal the JAX
    package's bf16 values for data already representable in float32."""
    rng = np.random.default_rng(8)
    dense = rng.standard_normal((41, 41)).astype(np.float32)
    jm = jax_tm.from_dense("D", dense.astype(jax_tm.np.dtype("float32")), MIXED[:4], MIXED[:4])
    pm = port_tm.from_dense("D", dense, MIXED[:4], MIXED[:4], dtype=torch.bfloat16,
                            device="cpu")
    want = torch.from_numpy(jax_tm.to_dense(jm)).to(torch.bfloat16).float().numpy()
    assert np.array_equal(port_tm.to_dense(pm), want)
