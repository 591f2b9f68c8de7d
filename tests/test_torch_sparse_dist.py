"""The port's block-sparse grid multiply (`dbcsr_tpu_torch.parallel`)
held against the JAX package's on the CPU.

The cases of `tests/test_sparse_dist.py`, after the reference's
mpiexec-with-N-ranks tests (SURVEY §4): the same numpy-seeded operands
(JAX matrices carried across with `dbcsr_tpu_torch.interop`) go through
the JAX package's `sparse_multiply_distributed` on its forced 8-device
CPU mesh (`make_grid`, as its own tests run it) and the port's on a
grid of CPU images (``devices=[cpu] * n``), whose tick stacks run the
acc layer's plain versions.  Grids: 1x1x1, 1x2x2, 2x2x2 (the layer
sum), 1x2x4 and 1x2x3 (the all-gather engine).

Tolerances: C's keys identical; values within 1e-12 of max |C| (f64,
c8) or 1e-5 (f32) of the JAX package's and of the dense NumPy product.
Within the port, one grid gives the same bits across repeats.
"""

import numpy as np
import pytest
import torch

from dbcsr_tpu.core import stats as jax_stats
from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.parallel import make_grid as jax_make_grid
from dbcsr_tpu.parallel import sparse_multiply_distributed as jax_smd
from dbcsr_tpu.parallel import tas_grouped_multiply as jax_tas_grouped
from dbcsr_tpu.parallel.sparse_dist import clear_mesh_plans as jax_clear_mesh_plans

from dbcsr_tpu_torch.core import stats
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.dist import Distribution, ProcessGrid, dist_bin, random_dist
from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.mm.multiply import multiply as port_multiply
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.ops.transformations import redistribute
from dbcsr_tpu_torch.parallel import make_grid, sparse_multiply_distributed, tas_grouped_multiply
from dbcsr_tpu_torch.parallel.sparse_dist import clear_mesh_plans

CPU = torch.device("cpu")
TOL = {np.float64: 1e-12, np.complex128: 1e-12, np.float32: 1e-5}
# (images, layers) -> 1x1x1, 1x2x2, 2x2x2, 1x2x4
GRIDS = [(1, None), (4, None), (8, None), (8, 1)]
GRID_IDS = ["1x1x1", "1x2x2", "2x2x2", "1x2x4"]


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
def configs():
    jkeys = ("mm_driver", "mm_format", "incremental", "cannon_overlap", "mm_dense")
    pkeys = ("mm_driver", "mm_format", "incremental", "cannon_overlap", "mm_dense")
    jcfg = {k: getattr(jax_get_config(), k) for k in jkeys}
    pcfg = {k: getattr(get_config(), k) for k in pkeys}
    jax_set_config(mm_format="stack", incremental="off", cannon_overlap="serial")
    set_config(incremental="off")
    yield
    jax_set_config(**jcfg)
    set_config(**pcfg)
    clear_mesh_plans()
    jax_clear_mesh_plans()


def jax_state(m) -> dict:
    return {"row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
            "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype),
            "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
            "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in m.bins]}


def _pair(name, rows, cols, occ, rng, dtype=np.float64, **kw):
    jm = jax_tm.make_random_matrix(name, rows, cols, dtype=dtype, occupation=occ, rng=rng,
                                   **kw)
    return jm, matrix_from_numpy_state(jax_state(jm), "cpu", name=name)


def _grids(n, layers=None):
    return jax_make_grid(n, layers=layers), make_grid(n, devices=[CPU] * n, layers=layers)


def _agree(pc, jc, oracle=None, tol=1e-12):
    """The port's C against the JAX package's: identical keys, values
    within ``tol`` of max |C|; and against a dense oracle when given."""
    assert np.array_equal(pc.keys, jc.keys)
    got = port_tm.to_dense(pc).astype(np.complex128)
    want = np.asarray(jax_tm.to_dense(jc)).astype(np.complex128)
    scale = np.max(np.abs(want), initial=0.0)
    assert np.max(np.abs(got - want), initial=0.0) <= tol * scale
    if oracle is not None:
        assert np.max(np.abs(got - oracle), initial=0.0) <= tol * max(
            np.max(np.abs(oracle), initial=0.0), 1e-300)


def _mixed(seed):
    rng = np.random.default_rng(seed)
    return (rng.choice([2, 3, 5], 11), rng.choice([4, 2], 9), rng.choice([3, 6], 13), rng)


@pytest.mark.parametrize("n,layers", GRIDS, ids=GRID_IDS)
def test_mixed_blocks_alpha_beta_match_jax(n, layers):
    rbs, kbs, cbs, rng = _mixed(3)
    ja, pa = _pair("A", rbs, kbs, 0.4, rng)
    jb, pb = _pair("B", kbs, cbs, 0.4, rng)
    jc, pc = _pair("C", rbs, cbs, 0.3, rng)
    jm, pm = _grids(n, layers)
    want = -0.5 * jax_tm.to_dense(ja) @ jax_tm.to_dense(jb) + 0.7 * jax_tm.to_dense(jc)
    jout = jax_smd(-0.5, ja, jb, 0.7, jc, jm)
    pout = sparse_multiply_distributed(-0.5, pa, pb, 0.7, pc, pm)
    _agree(pout, jout, want)
    assert pout._mesh["engine"] == ("gather" if pm.pr != pm.pc else "cannon")
    assert pout._last_flops == jout._last_flops
    # the padded panels' flops beside the true flops
    assert pout._mesh["padded_flops"] >= pout._mesh["true_flops"] == pout._last_flops


@pytest.mark.parametrize("n,layers", GRIDS, ids=GRID_IDS)
def test_float32_matches_jax(n, layers):
    rng = np.random.default_rng(5)
    rbs = [4] * 10
    ja, pa = _pair("A", rbs, rbs, 0.4, rng, np.float32)
    jb, pb = _pair("B", rbs, rbs, 0.4, rng, np.float32)
    jm, pm = _grids(n, layers)
    pout = sparse_multiply_distributed(1.0, pa, pb, 0.0, None, pm)
    assert pout.dtype == torch.float32
    _agree(pout, jax_smd(1.0, ja, jb, 0.0, None, jm), tol=TOL[np.float32])


@pytest.mark.parametrize("n,layers", [(4, None), (8, 1)], ids=["1x2x2", "1x2x4"])
def test_complex128_matches_jax(n, layers):
    rng = np.random.default_rng(7)
    rbs = [3] * 8
    ja, pa = _pair("A", rbs, rbs, 0.5, rng, np.complex128)
    jb, pb = _pair("B", rbs, rbs, 0.5, rng, np.complex128)
    jc, pc = _pair("C", rbs, rbs, 0.3, rng, np.complex128)
    jm, pm = _grids(n, layers)
    alpha, beta = 1.0 - 0.5j, 0.25 + 1.0j
    pout = sparse_multiply_distributed(alpha, pa, pb, beta, pc, pm)
    _agree(pout, jax_smd(alpha, ja, jb, beta, jc, jm))


@pytest.mark.parametrize("n,layers", [(8, None), (6, None)], ids=["2x2x2", "1x2x3"])
def test_filter_eps_matches_jax_and_single_device(n, layers):
    rng = np.random.default_rng(11)
    rbs = [4] * 12
    ja, pa = _pair("A", rbs, rbs, 0.5, rng)
    jb, pb = _pair("B", rbs, rbs, 0.5, rng)
    jm, pm = _grids(n, layers)
    pout = sparse_multiply_distributed(1.0, pa, pb, 0.0, None, pm, filter_eps=2.0)
    assert len(pout.keys) < 12 * 12  # filtering did something
    _agree(pout, jax_smd(1.0, ja, jb, 0.0, None, jm, filter_eps=2.0))
    ref = port_tm.make_random_matrix("r", rbs, rbs, occupation=0.0, device="cpu")
    port_multiply("N", "N", 1.0, pa, pb, 0.0, ref, filter_eps=2.0)
    assert np.array_equal(pout.keys, ref.keys)


@pytest.mark.parametrize("n,layers", [(4, None), (8, 1)], ids=["1x2x2", "1x2x4"])
def test_retain_sparsity_matches_jax(n, layers):
    rng = np.random.default_rng(13)
    rbs = [3] * 10
    ja, pa = _pair("A", rbs, rbs, 0.5, rng)
    jb, pb = _pair("B", rbs, rbs, 0.5, rng)
    jc, pc = _pair("C", rbs, rbs, 0.3, rng)
    jm, pm = _grids(n, layers)
    pout = sparse_multiply_distributed(1.0, pa, pb, 1.0, pc, pm, retain_sparsity=True)
    assert np.array_equal(pout.keys, pc.keys)
    _agree(pout, jax_smd(1.0, ja, jb, 1.0, jc, jm, retain_sparsity=True))


@pytest.mark.parametrize("n,layers", [(8, None), (6, None)], ids=["2x2x2", "1x2x3"])
def test_block_limits_with_windowed_beta_match_jax(n, layers):
    rbs, kbs, cbs, rng = _mixed(17)
    ja, pa = _pair("A", rbs, kbs, 0.5, rng)
    jb, pb = _pair("B", kbs, cbs, 0.5, rng)
    jc, pc = _pair("C", rbs, cbs, 0.5, rng)
    jm, pm = _grids(n, layers)
    lim = dict(first_row=2, last_row=8, first_col=1, last_col=9, first_k=1, last_k=6)
    pout = sparse_multiply_distributed(0.5, pa, pb, 2.0, pc, pm, **lim)
    _agree(pout, jax_smd(0.5, ja, jb, 2.0, jc, jm, **lim))


@pytest.mark.parametrize("n,layers", [(4, None), (8, 1)], ids=["1x2x2", "1x2x4"])
def test_unaligned_element_limits_match_jax_and_single_device(n, layers):
    rng = np.random.default_rng(19)
    rbs = [3] * 8
    ja, pa = _pair("A", rbs, rbs, 0.6, rng)
    jb, pb = _pair("B", rbs, rbs, 0.6, rng)
    jc, pc = _pair("C", rbs, rbs, 0.5, rng)
    jm, pm = _grids(n, layers)
    el = (2, 17, 4, 20, 1, 22)
    pout = sparse_multiply_distributed(1.5, pa, pb, 0.5, pc, pm, element_limits=el)
    _agree(pout, jax_smd(1.5, ja, jb, 0.5, jc, jm, element_limits=el))
    ref = pc.copy()
    port_multiply("N", "N", 1.5, pa, pb, 0.5, ref, element_limits=el)
    assert np.max(np.abs(port_tm.to_dense(ref) - port_tm.to_dense(pout))) <= 1e-12 * max(
        np.max(np.abs(port_tm.to_dense(ref))), 1e-300)


def test_element_k_window_matches_jax():
    rng = np.random.default_rng(21)
    rbs = [4] * 6
    ja, pa = _pair("A", rbs, rbs, 0.8, rng)
    jb, pb = _pair("B", rbs, rbs, 0.8, rng)
    jm, pm = _grids(4)
    el = (None, None, None, None, 3, 17)
    pout = sparse_multiply_distributed(1.0, pa, pb, 0.0, None, pm, element_limits=el)
    _agree(pout, jax_smd(1.0, ja, jb, 0.0, None, jm, element_limits=el))


def test_symmetric_operands_match_jax():
    rng = np.random.default_rng(23)
    rbs = [3] * 8
    ja, pa = _pair("A", rbs, rbs, 0.5, rng, matrix_type="S")
    jb, pb = _pair("B", rbs, rbs, 0.5, rng)
    jc, pc = _pair("C", rbs, rbs, 0.4, rng, matrix_type="S")
    jm, pm = _grids(4)
    want = (jax_tm.to_dense(ja) @ jax_tm.to_dense(jb)) + jax_tm.to_dense(jc)
    pout = sparse_multiply_distributed(1.0, pa, pb, 1.0, pc, pm)
    assert pout.matrix_type == "N"
    _agree(pout, jax_smd(1.0, ja, jb, 1.0, jc, jm), want)


@pytest.mark.parametrize("n,layers", [(4, None), (8, None)], ids=["1x2x2", "2x2x2"])
def test_dense_mode_matches_jax(n, layers):
    """High-fill products run the dense Cannon over the same grid, mixed
    blockings padded to the grid's divisibility."""
    rng = np.random.default_rng(63)
    rbs, kbs, cbs = rng.choice([3, 5], 7), rng.choice([2, 4], 6), rng.choice([3, 6], 5)
    ja, pa = _pair("A", rbs, kbs, 0.9, rng)
    jb, pb = _pair("B", kbs, cbs, 0.9, rng)
    jc, pc = _pair("C", rbs, cbs, 0.5, rng)
    jm, pm = _grids(n, layers)
    jax_set_config(mm_dense=True)
    set_config(mm_dense=True)
    jout = jax_smd(-2.0, ja, jb, 0.5, jc, jm)
    pout = sparse_multiply_distributed(-2.0, pa, pb, 0.5, pc, pm)
    assert pout._mm_algorithm == jout._mm_algorithm == "dense"
    _agree(pout, jout)
    assert pout._last_flops == jout._last_flops


def test_dense_mode_never_on_filtered_products():
    rng = np.random.default_rng(66)
    rbs = [4] * 8
    _, pa = _pair("A", rbs, rbs, 0.95, rng)
    _, pb = _pair("B", rbs, rbs, 0.95, rng)
    _, pc = _pair("C", rbs, rbs, 0.3, rng)
    pm = make_grid(4, devices=[CPU] * 4)
    assert sparse_multiply_distributed(1.0, pa, pb, 0.0, None, pm,
                                       filter_eps=1e-8)._mm_algorithm == "stack"
    assert sparse_multiply_distributed(1.0, pa, pb, 1.0, pc, pm,
                                       retain_sparsity=True)._mm_algorithm == "stack"


@pytest.mark.parametrize("n,layers", GRIDS, ids=GRID_IDS)
def test_repeats_are_bitwise_and_hit_the_plan_cache(n, layers):
    rbs, kbs, cbs, rng = _mixed(29)
    _, pa = _pair("A", rbs, kbs, 0.4, rng)
    _, pb = _pair("B", kbs, cbs, 0.4, rng)
    pm = make_grid(n, devices=[CPU] * n, layers=layers)
    stats.reset()
    c1 = sparse_multiply_distributed(1.0, pa, pb, 0.0, None, pm)
    assert c1._mm_plan_cache == "miss" and stats._comm["host2dev"].nbytes > 0
    stats.reset()
    c2 = sparse_multiply_distributed(1.0, pa, pb, 0.0, None, pm)
    # a repeat plans nothing, assembles nothing and uploads nothing
    assert c2._mm_plan_cache == "hit" and stats._comm["host2dev"].nbytes == 0
    for x, y in zip(c1.bins, c2.bins):
        assert torch.equal(x.data, y.data)
    assert port_tm.checksum(c1) == port_tm.checksum(c2)
    stats.reset()


def test_value_change_reassembles_the_panels():
    rng = np.random.default_rng(52)
    rbs = [3] * 9
    _, pa = _pair("A", rbs, rbs, 0.5, rng)
    _, pb = _pair("B", rbs, rbs, 0.5, rng)
    pm = make_grid(8, devices=[CPU] * 8)
    c1 = sparse_multiply_distributed(1.0, pa, pb, 0.0, None, pm)
    pa.map_bin_data(lambda d: d.mul_(2.0))  # in place: same tensors, new version
    c2 = sparse_multiply_distributed(1.0, pa, pb, 0.0, None, pm)
    assert c2._mm_plan_cache == "hit"
    np.testing.assert_allclose(port_tm.to_dense(c2), 2.0 * port_tm.to_dense(c1),
                               rtol=1e-12, atol=1e-12)


def test_c_feedback_loop_matches_dense():
    rng = np.random.default_rng(54)
    rbs = [4] * 8
    _, pa = _pair("A", rbs, rbs, 0.5, rng)
    _, pb = _pair("B", rbs, rbs, 0.5, rng)
    pm = make_grid(8, devices=[CPU] * 8)
    c, dense_c = None, np.zeros((32, 32))
    for _ in range(3):
        c = sparse_multiply_distributed(1.0, pa, pb, 0.5, c, pm)
        dense_c = port_tm.to_dense(pa) @ port_tm.to_dense(pb) + 0.5 * dense_c
    np.testing.assert_allclose(port_tm.to_dense(c), dense_c, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,layers", [(8, None), (6, None)], ids=["2x2x2", "1x2x3"])
def test_comm_statistics_match_jax(n, layers):
    rng = np.random.default_rng(30)
    rbs = [4] * 8
    ja, pa = _pair("A", rbs, rbs, 0.5, rng)
    jb, pb = _pair("B", rbs, rbs, 0.5, rng)
    jm, pm = _grids(n, layers)
    stats.reset()
    jax_stats.reset()
    jax_smd(1.0, ja, jb, 0.0, None, jm)
    sparse_multiply_distributed(1.0, pa, pb, 0.0, None, pm)
    kinds = ("ppermute", "psum") if pm.pr == pm.pc else ("all_gather",)
    for kind in kinds:
        assert stats._comm[kind].nmessages == jax_stats._comm[kind].nmessages, kind
        assert stats._comm[kind].nbytes > 0
    lines = []
    stats.print_statistics(out=lines.append)
    assert kinds[0] in "\n".join(lines) and "host2dev" in "\n".join(lines)
    stats.reset()
    jax_stats.reset()


def test_honors_distributions():
    """The same product under three distributions of the operands
    (default cyclic, random, load-balanced `dist_bin`) gives the same
    keys and values within 1e-12 (ref `dbcsr_dist_methods.F:49`)."""
    rbs = list(np.random.default_rng(0).choice([3, 5], 12))
    rng = np.random.default_rng(20)
    _, pa = _pair("A", rbs, rbs, 0.4, rng)
    _, pb = _pair("B", rbs, rbs, 0.4, rng)
    pm = make_grid(4, devices=[CPU] * 4)
    want = port_tm.to_dense(pa) @ port_tm.to_dense(pb)
    grid = ProcessGrid(2, 2, pm)
    n = len(rbs)
    for d in (None,
              Distribution(random_dist(n, 2, seed=1), random_dist(n, 2, seed=2), grid),
              Distribution(dist_bin(n, 2, element_sizes=np.asarray(rbs)),
                           dist_bin(n, 2, element_sizes=np.asarray(rbs)[::-1].copy()), grid)):
        a, b = (pa, pb) if d is None else (redistribute(pa, d), redistribute(pb, d))
        c = sparse_multiply_distributed(1.0, a, b, 0.0, None, pm)
        np.testing.assert_allclose(port_tm.to_dense(c), want, rtol=1e-12, atol=1e-12)


def test_rejects_bad_blocking():
    rng = np.random.default_rng(21)
    _, pa = _pair("A", [3] * 8, [3] * 8, 0.5, rng)
    _, pb = _pair("B", [3] * 8, [3] * 8, 0.5, rng)
    _, pbad = _pair("C", [3] * 8, [4] * 6, 0.5, rng)
    with pytest.raises(ValueError):
        sparse_multiply_distributed(1.0, pa, pb, 1.0, pbad, make_grid(4, devices=[CPU] * 4))


def test_stacks_run_on_the_acc_layer_and_plan_once():
    """Every (image, tick) stack is prepared once per plan (K1 on the
    card; its plain version here) and launched on every repeat."""
    from dbcsr_tpu_torch.acc import stack_kernel

    rng = np.random.default_rng(31)
    rbs = [5] * 10
    _, pa = _pair("A", rbs, rbs, 0.5, rng)
    _, pb = _pair("B", rbs, rbs, 0.5, rng)
    pm = make_grid(4, devices=[CPU] * 4)
    stack_kernel.reset_counts()
    c = sparse_multiply_distributed(1.0, pa, pb, 0.0, None, pm)
    nstacks = len(c._mesh["stacks"])
    assert nstacks > pm.size  # several ticks per image
    assert set(c._mesh["kernels"].values()) == {"smm_stack"}
    assert stack_kernel.plain_calls == nstacks
    c2 = sparse_multiply_distributed(1.0, pa, pb, 0.0, None, pm)
    assert stack_kernel.plain_calls == 2 * nstacks and c2._mesh["stacks"] == c._mesh["stacks"]


# ------------------------------------------------------------ grouped TAS
def _tall(seed, nlong=24, nshort=4):
    rng = np.random.default_rng(seed)
    return rng.integers(2, 6, nlong), rng.integers(2, 6, nshort), rng


@pytest.mark.parametrize("nsplit", [None, 3, 8])
def test_tas_grouped_matches_jax(nsplit):
    ls, ss, rng = _tall(36)
    ja, pa = _pair("A", ls, ss, 0.4, rng)
    jb, pb = _pair("B", ss, ss, 0.7, rng)
    jm, pm = _grids(8)
    pout = tas_grouped_multiply(1.0, pa, pb, 0.0, None, pm, nsplit=nsplit)
    jout = jax_tas_grouped(1.0, ja, jb, 0.0, None, jm, nsplit=nsplit)
    _agree(pout, jout, jax_tm.to_dense(ja) @ jax_tm.to_dense(jb))
    assert pout._tas_ngroups == jout._tas_ngroups


def test_tas_grouped_beta_matches_jax():
    ls, ss, rng = _tall(38)
    ja, pa = _pair("A", ls, ss, 0.5, rng)
    jb, pb = _pair("B", ss, ss, 0.7, rng)
    jc, pc = _pair("C", ls, ss, 0.3, rng)
    jm, pm = _grids(8)
    pout = tas_grouped_multiply(2.0, pa, pb, -0.5, pc, pm, nsplit=4)
    _agree(pout, jax_tas_grouped(2.0, ja, jb, -0.5, jc, jm, nsplit=4))


def test_tas_grouped_refuses_a_rectangular_grid():
    ls, ss, rng = _tall(39)
    _, pa = _pair("A", ls, ss, 0.5, rng)
    _, pb = _pair("B", ss, ss, 0.7, rng)
    with pytest.raises(ValueError, match="square"):
        tas_grouped_multiply(1.0, pa, pb, 0.0, None, make_grid(6, devices=[CPU] * 6))


@pytest.mark.parametrize("n,layers", [(6, None), (6, 2)], ids=["1x2x3", "2x1x3"])
def test_rectangular_grids_match_jax(n, layers):
    rbs, kbs, cbs, rng = _mixed(40)
    ja, pa = _pair("A", rbs, kbs, 0.5, rng)
    jb, pb = _pair("B", kbs, cbs, 0.5, rng)
    jc, pc = _pair("C", rbs, cbs, 0.4, rng)
    jm, pm = _grids(n, layers)
    pout = sparse_multiply_distributed(2.0, pa, pb, 0.5, pc, pm)
    assert pout._mesh["engine"] == "gather"
    _agree(pout, jax_smd(2.0, ja, jb, 0.5, jc, jm))
