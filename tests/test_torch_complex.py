"""Complex kinds in the port (dtype enums 5 and 7) held against the JAX
package on the CPU.

The same numpy-seeded matrices (each complex block draws its real part,
then its imaginary part) go through both packages: the generator's
blocks bit for bit; `multiply` for every pair of N/T/C flags with
complex alpha and beta within 1e-12 (complex128) or 2e-5 (complex64) of
the JAX product, on the stack format and on the dense and composite
formats (against the stack leg); `new_transposed` with ``conjugate``,
Hermitian storage and `desymmetrize`, `dot` of Hermitian operands,
`trace` and the norms (real, in the real dtype of matching precision)
within 1e-12; the host driver's complex128 path against the plain
version; the perf driver's checksums against the JAX driver's; the
ABFT probe on a complex stack.  The plain version (what a CPU tensor
runs) stands in for K1's complex forms, which run on the card only.
"""

import numpy as np
import pytest
import torch

from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.mm.multiply import multiply as jax_multiply
from dbcsr_tpu.ops import operations as jax_ops
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.ops import transformations as jax_tr
from dbcsr_tpu.perf.driver import PerfConfig as JaxPerfConfig
from dbcsr_tpu.perf.driver import run_perf as jax_run_perf
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics

from dbcsr_tpu_torch.acc import abft, stack_kernel
from dbcsr_tpu_torch.acc import smm as port_smm
from dbcsr_tpu_torch.core import kinds
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.interop import matrix_from_numpy_state, matrix_to_numpy_state
from dbcsr_tpu_torch.mm import multiply as port_mm
from dbcsr_tpu_torch.obs import metrics
from dbcsr_tpu_torch.ops import operations as port_ops
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.ops import transformations as port_tr
from dbcsr_tpu_torch.perf.driver import PerfConfig, run_perf
from dbcsr_tpu_torch.resilience import breaker, faults

SIZES = np.array([3, 5, 4, 5, 2, 4])
RTOL = {np.complex128: 1e-12, np.complex64: 2e-5}
_CFG = ("mm_driver", "mm_format", "abft", "incremental")


@pytest.fixture(autouse=True)
def configs_restored():
    jcfg = {k: getattr(jax_get_config(), k) for k in ("mm_driver", "mm_format", "incremental")}
    pcfg = {k: getattr(get_config(), k) for k in _CFG}
    jax_set_config(incremental="off")
    yield
    faults.clear()
    breaker.reset_board()
    metrics.reset()
    abft.discard_pending()
    port_mm.clear_plan_cache()
    # the JAX package's many complex specializations would leave its
    # health model reporting a recompile storm to the tests after these
    jax_metrics.reset()
    jax_events.clear()
    jax_health.reset()
    jax_set_config(**jcfg)
    set_config(**pcfg)


def _pair(seed, dtype=np.complex128, occ=0.6, kind="N", rows=SIZES, cols=SIZES):
    """The same seeded matrix from both packages."""
    jm = jax_tm.make_random_matrix("R", rows, cols, dtype=dtype, occupation=occ,
                                   matrix_type=kind, rng=np.random.default_rng(seed))
    pm = port_tm.make_random_matrix("R", rows, cols, dtype=dtype, occupation=occ,
                                    matrix_type=kind, rng=np.random.default_rng(seed),
                                    device="cpu")
    return jm, pm


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


def test_kinds_map_complex():
    assert kinds.dtype_of(5) == torch.complex64 and kinds.dtype_of(7) == torch.complex128
    assert kinds.enum_of(torch.complex64) == 5 and kinds.enum_of("complex128") == 7
    assert kinds.dtype_of(np.complex64) == torch.complex64
    assert kinds.is_complex(7) and not kinds.is_complex(3)
    assert kinds.real_dtype_of(torch.complex64) == torch.float32
    assert kinds.real_dtype_of(7) == torch.float64 and kinds.real_dtype_of(1) == torch.float32
    assert kinds.host_dtype(5) == np.dtype(np.complex64)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("kind", ["N", "H"])
def test_random_matrix_matches_jax(dtype, kind):
    jm, pm = _pair(3, dtype, kind=kind)
    assert pm.dtype == kinds.dtype_of(dtype) and pm.matrix_type == kind
    np.testing.assert_array_equal(pm.keys, jm.keys)
    np.testing.assert_array_equal(port_tm.to_dense(pm), jax_tm.to_dense(jm))
    back = matrix_from_numpy_state(matrix_to_numpy_state(pm), device="cpu")
    np.testing.assert_array_equal(port_tm.to_dense(back), jax_tm.to_dense(jm))


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("transa,transb", [("N", "N"), ("T", "N"), ("N", "C"), ("C", "T"),
                                           ("C", "C")])
def test_multiply_flags_against_jax(dtype, transa, transb):
    """C = alpha op(A) op(B) + beta C with complex scalars, both packages
    on the same operands."""
    ja, pa = _pair(11, dtype)
    jb, pb = _pair(12, dtype)
    jc, pc = _pair(13, dtype, occ=0.3)
    alpha, beta = 0.75 - 0.5j, 0.25 + 1.0j
    jax_set_config(mm_format="stack")
    jax_multiply(transa, transb, alpha, ja, jb, beta, jc)
    set_config(mm_format="stack")
    port_mm.multiply(transa, transb, alpha, pa, pb, beta, pc)
    assert pc._mm_algorithm == "stack"
    assert _rel(port_tm.to_dense(pc), jax_tm.to_dense(jc)) <= RTOL[dtype]


def _banded(seed, dtype, nblk=8, bsize=4, band=1):
    """A block-banded complex matrix (the composite format's pattern)."""
    rng = np.random.default_rng(seed)
    n = nblk * bsize
    dense = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(dtype)
    blk = np.arange(n) // bsize
    dense[np.abs(blk[:, None] - blk[None, :]) > band] = 0
    return port_tm.from_dense("B", dense, [bsize] * nblk, [bsize] * nblk, device="cpu")


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("fmt", ["dense", "composite"])
def test_canvas_formats_take_complex(dtype, fmt):
    """The dense and composite formats (torch.matmul/bmm) against the
    stack format: full operands for dense, banded ones for composite."""
    if fmt == "dense":
        sizes = np.full(8, 4)
        a = _pair(21, dtype, occ=1.0, rows=sizes, cols=sizes)[1]
        b = _pair(22, dtype, occ=1.0, rows=sizes, cols=sizes)[1]
    else:
        a, b = _banded(21, dtype), _banded(22, dtype)
    c0 = _pair(23, dtype, occ=0.5, rows=a.row_blk_sizes, cols=b.col_blk_sizes)[1]
    out = {}
    for f in ("stack", fmt):
        set_config(mm_format=f)
        c = c0.copy()
        port_mm.multiply("N", "N", 0.5 + 0.5j, a, b, -1.0j, c)
        out[f] = port_tm.to_dense(c)
    assert c._mm_algorithm == fmt
    assert _rel(out[fmt], out["stack"]) <= RTOL[dtype]


def test_complex_scalars_need_a_complex_c():
    pa = _pair(2, np.float64)[1]
    with pytest.raises(TypeError, match="complex alpha/beta"):
        port_mm.multiply("N", "N", 1.0 + 1.0j, pa, pa, 0.0, pa.copy())
    pz = _pair(2)[1]
    c = pz.copy()
    port_mm.multiply("N", "N", 1.0j, pz, pz, 0.0, c)  # a complex C takes them
    d = port_tm.to_dense(pz)
    assert _rel(port_tm.to_dense(c), 1.0j * d @ d) <= 1e-12


def test_new_transposed_conjugate_against_jax():
    ja, pa = _pair(19, occ=0.7)
    for conj in (False, True):
        got = port_tm.to_dense(port_tr.new_transposed(pa, conjugate=conj))
        want = jax_tm.to_dense(jax_tr.new_transposed(ja, conjugate=conj))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_tm.to_dense(port_tr.new_transposed(pa, conjugate=True)),
                                  port_tm.to_dense(pa).conj().T)


def test_hermitian_storage_and_desymmetrize():
    jh, ph = _pair(31, occ=0.8, kind="H")
    dense = port_tm.to_dense(ph)
    np.testing.assert_array_equal(dense, dense.conj().T)
    np.testing.assert_array_equal(port_tm.to_dense(port_tr.desymmetrize(ph)),
                                  jax_tm.to_dense(jax_tr.desymmetrize(jh)))
    r, c = 1, 3
    blk = ph.get_block(c, r)  # a lower block unfolds to the stored one's conjugate transpose
    np.testing.assert_array_equal(blk, ph.get_block(r, c).conj().T)
    # a real hermitian matrix is symmetric
    assert BlockSparseMatrix("R", SIZES, SIZES, matrix_type="H", device="cpu").matrix_type == "S"


@pytest.mark.parametrize("kind", ["N", "H"])
def test_dot_trace_norms_against_jax(kind):
    ja, pa = _pair(43, occ=1.0, kind=kind)
    jb, pb = _pair(44, occ=1.0, kind=kind)
    got, want = port_ops.dot(pa, pb), jax_ops.dot(ja, jb)
    assert isinstance(got, complex)
    assert abs(got - want) <= 1e-12 * abs(want)
    dense = (port_tm.to_dense(pa) * port_tm.to_dense(pb)).sum()
    assert abs(got - dense) <= 1e-12 * abs(dense)
    tr = port_ops.trace(pa)
    assert isinstance(tr, complex) and abs(tr - jax_ops.trace(ja)) <= 1e-12 * abs(tr)
    for name in ("frobenius_norm", "maxabs_norm", "gershgorin_norm"):
        g, w = getattr(port_ops, name)(pa), getattr(jax_ops, name)(ja)
        assert isinstance(g, float) and abs(g - w) <= 1e-12 * w, name
    norms = pa.block_norms()
    assert norms.dtype == np.float64
    np.testing.assert_allclose(norms, ja.block_norms(), rtol=1e-13)


def test_scale_add_and_diag_ops_complex():
    ja, pa = _pair(51, occ=0.8)
    jb, pb = _pair(52, occ=0.8)
    for pk, jk in ((port_ops, jax_ops),):
        pk.scale(pa, 2.0 - 1.0j)
        jk.scale(ja, 2.0 - 1.0j)
        pk.add(pa, pb, 0.5j, -1.0)
        jk.add(ja, jb, 0.5j, -1.0)
        pk.add_on_diag(pa, 1.0 + 2.0j)
        jk.add_on_diag(ja, 1.0 + 2.0j)
    assert _rel(port_tm.to_dense(pa), jax_tm.to_dense(ja)) <= 1e-12


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_host_driver_complex_path(dtype):
    """The native host driver's c4/c8 path against the plain version, on
    the same stack."""
    pa, pb = _pair(61, dtype)[1], _pair(62, dtype)[1]
    out = {}
    for drv in ("torch", "host"):
        set_config(mm_driver=drv, mm_format="stack")
        c = _pair(63, dtype, occ=0.3)[1]
        port_mm.multiply("N", "N", 0.5 - 0.25j, pa, pb, 1.5j, c)
        out[drv] = port_tm.to_dense(c)
    assert _rel(out["host"], out["torch"]) <= RTOL[dtype]


def test_crosspack_refuses_complex():
    pa = _pair(71)[1]
    c = torch.zeros((4, 5, 5), dtype=torch.complex128)
    a = pa.bins[0].data
    with pytest.raises(TypeError, match="crosspack"):
        port_smm.prepare_stack(c, a[:, :5, :5].contiguous(), a[:, :5, :5].contiguous(),
                               [0, 1], [1, 0], [0, 2], variant="crosspack")
    set_config(mm_driver="pallas_cross", mm_format="stack")
    with pytest.raises(TypeError, match="crosspack"):
        port_mm.multiply("N", "N", 1.0, pa, pa, 0.0, pa.copy())


def test_stack_kernel_complex_alpha_plain():
    """The wrapper's complex form on CPU tensors (its plain version):
    C + alpha * sum of the run's products, complex alpha."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((6, 3, 4)) + 1j * rng.standard_normal((6, 3, 4)))
    b = torch.from_numpy(rng.standard_normal((6, 4, 2)) + 1j * rng.standard_normal((6, 4, 2)))
    c = torch.from_numpy(rng.standard_normal((2, 3, 2)) + 1j * rng.standard_normal((2, 3, 2)))
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    got = stack_kernel.smm_stack(c.clone(), a, b, i32([0, 2, 5]), i32([1, 1, 4]), i32([0, 2, 3]),
                                 i32([1, 0]), 2.0 - 0.5j)
    want = c.numpy().copy()
    an, bn = a.numpy(), b.numpy()
    want[1] += (2.0 - 0.5j) * (an[0] @ bn[1] + an[2] @ bn[1])
    want[0] += (2.0 - 0.5j) * (an[5] @ bn[4])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)
    with pytest.raises(TypeError, match="no .* form"):
        stack_kernel.smm_stack(c.clone(), a, b, i32([0]), i32([0]), i32([0, 1]), i32([0]), 1.0,
                               precision=("float32", False))


@pytest.mark.parametrize("data_type", [5, 7])
def test_perf_driver_checksums_against_jax(data_type):
    kw = dict(m=30, n=24, k=27, sparsity_a=0.4, sparsity_b=0.4, sparsity_c=0.6,
              data_type=data_type, alpha=0.5 + 0.5j, beta=1.0 - 0.5j, nrep=2,
              m_sizes=[(1, 5), (1, 4)], n_sizes=[(1, 3)], k_sizes=[(2, 4), (1, 5)])
    jax_set_config(mm_format="stack")
    want = jax_run_perf(JaxPerfConfig(**kw), verbose=False)
    got = run_perf(PerfConfig(**kw), verbose=False, device="cpu")
    tol = RTOL[np.complex128 if data_type == 7 else np.complex64]
    for key in ("checksum", "checksum_pos"):
        assert abs(got[key] - want[key]) <= tol * abs(want[key]), key
    assert got["plan_cache"] == ["miss", "hit"]  # the repeats ran the engine


def test_abft_probe_catches_a_flip_in_a_complex_stack():
    set_config(abft="verify", mm_format="stack")
    pa, pb = _pair(81)[1], _pair(82)[1]
    clean = pa.copy()
    port_mm.multiply("N", "N", 1.0j, pa, pb, 0.0, clean)
    c = pa.copy()
    with faults.inject_faults("execute_stack:flip,seed=3,times=1") as sp:
        port_mm.multiply("N", "N", 1.0j, pa, pb, 0.0, c)
    assert sp[0].fired == 1
    assert sum(v for _, v in metrics.counter_items("dbcsr_tpu_abft_mismatches_total")) == 1
    np.testing.assert_array_equal(port_tm.to_dense(c), port_tm.to_dense(clean))
