"""The port's linear-scaling DFT iterations held against the JAX package
on the CPU.

The same density, drawn by `make_test_density` from one seed in each
package, goes through McWeeny purification, the Newton-Schulz sign
iteration and the coupled Newton-Schulz inverse square root of both
packages, filtered and unfiltered, at 4-6 block rows of 3.

Tolerances: the drawn densities are equal bit for bit; histories and
final iterates agree at relative 1e-10 (an iterate against its max
magnitude, a history against its largest entry, since a residual at the
rounding floor differs by its own size); the JAX tests' own oracles
(dense products 1e-11-1e-12, a projector 1e-8, sign(A) 1e-6-1e-8, dense
eig for S^-1/2 1e-8) hold at theirs.
"""

import numpy as np
import pytest

from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.core.matrix import BlockSparseMatrix as JaxMatrix
from dbcsr_tpu.mm.multiply import multiply as jax_multiply
from dbcsr_tpu.models import invsqrt as jax_invsqrt
from dbcsr_tpu.models import purify as jax_purify
from dbcsr_tpu.models import sign as jax_sign
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries
from dbcsr_tpu.ops import operations as jops
from dbcsr_tpu.ops import test_methods as jax_tm

from dbcsr_tpu_torch.core import mempool
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.mm.multiply import multiply as port_multiply
from dbcsr_tpu_torch.models import invsqrt as port_invsqrt
from dbcsr_tpu_torch.models import (
    invsqrt_iteration,
    invsqrt_step,
    make_test_density,
    mcweeny_purify,
    mcweeny_step,
    sign_iteration,
    sign_step,
)
from dbcsr_tpu_torch.ops import operations as pops
from dbcsr_tpu_torch.ops import test_methods as port_tm

RTOL = 1e-10


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
def jax_stack_config():
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


def densities(n_blocks=5, block=3, occ=0.5, seed=1):
    jd = jax_purify.make_test_density(n_blocks, block, occ=occ, seed=seed)
    pd = make_test_density(n_blocks, block, occ=occ, seed=seed, device="cpu")
    assert pd.matrix_type == jd.matrix_type == "N"
    assert np.array_equal(pd.keys, jd.keys)
    assert np.array_equal(port_tm.to_dense(pd), jax_tm.to_dense(jd))
    return jd, pd


def shifted(jd, pd, alpha):
    """Both densities' copies with ``alpha`` added on the diagonal."""
    ja, pa = jd.copy("A"), pd.copy("A")
    jops.add_on_diag(ja, alpha)
    pops.add_on_diag(pa, alpha)
    return ja, pa


def assert_iterate(pm, jm):
    want = jax_tm.to_dense(jm)
    got = port_tm.to_dense(pm)
    assert np.max(np.abs(got - want)) <= RTOL * np.max(np.abs(want))


def assert_history(got, want):
    assert len(got) == len(want)
    got, want = np.asarray(got), np.asarray(want)
    assert np.max(np.abs(got - want)) <= RTOL * np.max(np.abs(want)), (got, want)


def spd_pair(seed, sizes, occ):
    """S = A A^T + n I from one draw: the JAX package's S, carried to the
    port as it is (the two multiplies round differently), after checking
    that the port's own multiply builds it to 1e-13."""
    n = sum(sizes)
    ja = jax_tm.make_random_matrix("A", sizes, sizes, occupation=occ,
                                   rng=np.random.default_rng(seed))
    js = JaxMatrix("S", np.asarray(sizes, np.int32), np.asarray(sizes, np.int32), np.float64)
    jax_multiply("N", "T", 1.0, ja, ja, 0.0, js)
    jops.add_on_diag(js, float(n))
    pa = port_tm.make_random_matrix("A", sizes, sizes, occupation=occ,
                                    rng=np.random.default_rng(seed), device="cpu")
    own = BlockSparseMatrix("S", sizes, sizes, device="cpu")
    port_multiply("N", "T", 1.0, pa, pa, 0.0, own)
    pops.add_on_diag(own, float(n))
    want = jax_tm.to_dense(js)
    assert np.max(np.abs(port_tm.to_dense(own) - want)) <= 1e-13 * np.max(np.abs(want))
    ps = matrix_from_numpy_state(jax_state(js), "cpu", name="S")
    assert np.array_equal(port_tm.to_dense(ps), want)
    return js, ps


# ------------------------------------------------------------------ purify
@pytest.mark.parametrize("eps", [None, 1e-6])
def test_mcweeny_step_matches_jax(eps):
    jd, pd = densities(4, 3, occ=0.6, seed=0)
    got = mcweeny_step(pd, filter_eps=eps)
    assert_iterate(got, jax_purify.mcweeny_step(jd, filter_eps=eps))
    if eps is None:
        d = port_tm.to_dense(pd)
        np.testing.assert_allclose(port_tm.to_dense(got), 3 * d @ d - 2 * d @ d @ d,
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("eps", [None, 1e-8])
def test_mcweeny_purify_matches_jax(eps):
    jd, pd = densities(6, 3, occ=0.4, seed=2)
    pf, ph = mcweeny_purify(pd, steps=6, filter_eps=eps)
    jf, jh = jax_purify.mcweeny_purify(jd, steps=6, filter_eps=eps)
    assert_history(ph, jh)
    assert_iterate(pf, jf)
    assert np.array_equal(port_tm.to_dense(pd), jax_tm.to_dense(jd))  # input untouched


def test_mcweeny_purify_converges_to_projector():
    jd, pd = densities(4, 3, occ=0.4, seed=2)
    pf, ph = mcweeny_purify(pd, steps=30, tol=1e-14)
    jf, jh = jax_purify.mcweeny_purify(jd, steps=30, tol=1e-14)
    assert_history(ph, jh)
    d = port_tm.to_dense(pf)
    np.testing.assert_allclose(d @ d, d, atol=1e-8)


# -------------------------------------------------------------------- sign
@pytest.mark.parametrize("eps", [None, 1e-6])
def test_sign_step_matches_jax(eps):
    jd, pd = densities(5, 3, occ=0.5, seed=3)
    ja, pa = shifted(jd, pd, -0.5)
    got = sign_step(pa, filter_eps=eps)
    assert_iterate(got, jax_sign.sign_step(ja, filter_eps=eps))
    if eps is None:
        x = port_tm.to_dense(pa)
        np.testing.assert_allclose(port_tm.to_dense(got),
                                   x @ (3 * np.eye(len(x)) - x @ x) / 2,
                                   rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("eps", [None, 1e-8])
def test_sign_iteration_matches_jax(eps):
    """The density shifted by -0.5: a spectrum straddling zero."""
    jd, pd = densities(6, 3, occ=0.5, seed=4)
    ja, pa = shifted(jd, pd, -0.5)
    px, ph = sign_iteration(pa, steps=8, filter_eps=eps)
    jx, jh = jax_sign.sign_iteration(ja, steps=8, filter_eps=eps)
    assert_history(ph, jh)
    assert_iterate(px, jx)


def test_sign_iteration_converges_to_sign():
    jd, pd = densities(6, 3, occ=0.4, seed=2)  # SPD: sign(A) = I
    px, ph = sign_iteration(pd, steps=30, tol=1e-12)
    jx, jh = jax_sign.sign_iteration(jd, steps=30, tol=1e-12)
    assert_history(ph, jh)
    np.testing.assert_allclose(port_tm.to_dense(px), np.eye(18), atol=1e-8)
    assert ph[-1] < 1e-8


def test_sign_iteration_mixed_spectrum():
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((12, 12)))
    eig = np.array([1.5, 2.0, 0.7, 1.1, 0.9, 0.8, -1.2, -0.5, -2.0, -0.9, 1.3, -1.4])
    d = (q * eig) @ q.T
    a = port_tm.from_dense("A", d, [3] * 4, [3] * 4, device="cpu")
    x, _ = sign_iteration(a, steps=60, tol=1e-13)
    np.testing.assert_allclose(port_tm.to_dense(x), (q * np.sign(eig)) @ q.T, atol=1e-6)


def test_sign_iteration_symmetric_storage_input():
    """A symmetric-stored input is desymmetrized before the loop, so its
    convergence check (a mixed-symmetry add otherwise) does not raise."""
    ja = jax_tm.make_random_matrix("A", [3] * 5, [3] * 5, occupation=0.6, matrix_type="S",
                                   rng=np.random.default_rng(9))
    pa = port_tm.make_random_matrix("A", [3] * 5, [3] * 5, occupation=0.6, matrix_type="S",
                                    rng=np.random.default_rng(9), device="cpu")
    px, ph = sign_iteration(pa, steps=3)
    jx, jh = jax_sign.sign_iteration(ja, steps=3)
    assert pa.matrix_type == "S"  # the caller's matrix keeps its kind
    assert_history(ph, jh)
    assert_iterate(px, jx)
    got = port_tm.to_dense(px)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, got.T, atol=1e-10)  # sign(A) is symmetric


# ----------------------------------------------------------------- invsqrt
def test_invsqrt_step_matches_jax():
    js, ps = spd_pair(31, [3, 3, 3, 3], occ=0.7)
    sf = pops.gershgorin_norm(ps)
    assert sf == jops.gershgorin_norm(js)
    jy, py = js.copy("Y"), ps.copy("Y")
    jops.scale(jy, 1.0 / sf)
    pops.scale(py, 1.0 / sf)
    jz, pz = jax_invsqrt._identity_like(js), port_invsqrt._identity_like(ps)
    assert np.array_equal(port_tm.to_dense(pz), jax_tm.to_dense(jz))
    py1, pz1 = invsqrt_step(py, pz)
    jy1, jz1 = jax_invsqrt.invsqrt_step(jy, jz)
    assert_iterate(py1, jy1)
    assert_iterate(pz1, jz1)
    dy, dz = port_tm.to_dense(py), port_tm.to_dense(pz)
    t = (3.0 * np.eye(len(dy)) - dz @ dy) / 2.0
    np.testing.assert_allclose(port_tm.to_dense(py1), dy @ t, rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(port_tm.to_dense(pz1), t @ dz, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("eps", [None, 1e-13])
def test_invsqrt_iteration_matches_jax(eps):
    sizes = [3, 4, 2, 3]
    js, ps = spd_pair(31, sizes, occ=0.7)
    hist = []
    pz, psf, pit = invsqrt_iteration(ps, tol=1e-12, filter_eps=eps, history=hist)
    jz, jsf, jit = jax_invsqrt.invsqrt_iteration(js, tol=1e-12, filter_eps=eps)
    assert (pit, psf) == (jit, jsf)
    assert pit < 30 and len(hist) == pit + 1 and hist[-1] < 1e-12
    assert_iterate(pz, jz)
    # the JAX tests' oracle: Z / sqrt(sf) = S^-1/2 by dense eig
    ds = port_tm.to_dense(ps)
    got = port_tm.to_dense(pz) / np.sqrt(psf)
    w, v = np.linalg.eigh(ds)
    np.testing.assert_allclose(got, v @ np.diag(w ** -0.5) @ v.T, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got @ ds @ got, np.eye(sum(sizes)), rtol=1e-8, atol=1e-8)


def test_invsqrt_of_the_shifted_density_matches_jax():
    """The smoke's overlap: the density plus 0.5 I, stored symmetric by
    the draw and desymmetrized by the iteration."""
    jd, pd = densities(5, 3, occ=0.5, seed=5)
    js, ps = shifted(jd, pd, 0.5)
    pz, psf, pit = invsqrt_iteration(ps, tol=1e-10)
    jz, jsf, jit = jax_invsqrt.invsqrt_iteration(js, tol=1e-10)
    assert (pit, psf) == (jit, jsf)
    assert_iterate(pz, jz)


# ------------------------------------------------------------------- chain
def test_loops_free_their_temporaries_and_keep_the_input():
    _, pd = densities(5, 3, occ=0.5, seed=6)
    before = port_tm.to_dense(pd)
    freed0 = mempool.pool_stats()["freed"]
    steps = 4
    pf, _ = mcweeny_purify(pd, steps=steps)
    # each step frees P^3, and the loop frees every iterate but the last
    assert mempool.pool_stats()["freed"] - freed0 == steps + steps - 1
    assert pd.valid and np.array_equal(port_tm.to_dense(pd), before)
    assert pf.valid and pf.nblks > 0 and mempool.current_chain() is None
