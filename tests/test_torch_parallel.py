"""The port's process grid, dense Cannon and distributed matrices
(`dbcsr_tpu_torch.parallel`) held against the JAX package on the CPU.

The cases of `tests/test_parallel.py`, the image-distribution case of
`tests/test_sparse_dist.py`, the grid re-factoring cases of
`tests/test_tas.py`, and the replication cases of
`tests/test_api_parity.py` (`replicate_all`) and `tests/test_csr_io.py`:
the JAX package runs on its forced 8-device CPU mesh, the port on a grid
of CPU images (``devices=[cpu] * n``), on the same numpy-seeded
operands.

Tolerances: grid shapes, image maps and replication layouts equal; dense
Cannon products within 1e-12 of max |C| (f64) or 1e-5 (f32) of the JAX
package's and of the NumPy product; distributed matrices' blocks within
1e-12, replication bit for bit.
"""

import numpy as np
import pytest
import torch

import dbcsr_tpu as jdt
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.parallel import ImageDistribution as JaxImages
from dbcsr_tpu.parallel import cannon_multiply_dense as jax_cannon
from dbcsr_tpu.parallel import grid_shape as jax_grid_shape
from dbcsr_tpu.parallel import make_grid as jax_make_grid
from dbcsr_tpu.parallel import make_image_dist as jax_make_image_dist
from dbcsr_tpu.parallel.mesh import optimize_grid as jax_optimize_grid

import dbcsr_tpu_torch as pdt
from dbcsr_tpu_torch.core.dist import Distribution, ProcessGrid
from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.parallel import (
    ImageDistribution,
    cannon_multiply_dense,
    collect,
    distribute,
    grid_shape,
    is_coordinator,
    make_grid,
    make_image_dist,
    make_multihost_grid,
    multiply_distributed,
    process_count,
    process_id,
    replicate,
)
from dbcsr_tpu_torch.parallel.mesh import Grid, optimize_grid

CPU = torch.device("cpu")


def jax_state(m) -> dict:
    return {"row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
            "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype),
            "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
            "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in m.bins]}


def _pair(name, rows, cols, occ, rng, **kw):
    jm = jax_tm.make_random_matrix(name, rows, cols, occupation=occ, rng=rng, **kw)
    return jm, matrix_from_numpy_state(jax_state(jm), "cpu", name=name)


def _grid(n, layers=None):
    return make_grid(n, devices=[CPU] * n, layers=layers)


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want), initial=0.0) <= tol * max(
        np.max(np.abs(want), initial=0.0), 1e-300)


# ------------------------------------------------------------------ grids
def test_grid_shape():
    assert grid_shape(1) == (1, 1, 1)
    assert grid_shape(4) == (1, 2, 2)
    assert grid_shape(8) == (2, 2, 2)
    assert grid_shape(9) == (1, 3, 3)
    assert grid_shape(16) == (1, 4, 4)
    assert grid_shape(8, layers=8) == (8, 1, 1)
    assert grid_shape(2) == (1, 1, 2)
    assert grid_shape(6) == (1, 2, 3)
    assert grid_shape(8, layers=1) == (1, 2, 4)
    assert grid_shape(12) == (3, 2, 2)
    with pytest.raises(ValueError, match="divisible"):
        grid_shape(6, layers=4)


@pytest.mark.parametrize("n", range(1, 17))
def test_grid_shape_matches_jax(n):
    assert grid_shape(n) == jax_grid_shape(n)
    for layers in (1, 2, 4):
        if n % layers == 0:
            assert grid_shape(n, layers) == jax_grid_shape(n, layers)


def test_num_layers_3d_config_shapes_grids():
    from dbcsr_tpu_torch.core.config import set_config

    set_config(num_layers_3d=2)
    try:
        assert grid_shape(8) == (2, 2, 2) and grid_shape(4) == (2, 1, 2)
    finally:
        set_config(num_layers_3d=0)
    with pytest.raises(ValueError):
        set_config(num_layers_3d=-1)


def test_make_grid_slots_and_shape():
    g = _grid(8)
    assert dict(g.shape) == {"kl": 2, "pr": 2, "pc": 2} == dict(jax_make_grid(8).shape)
    assert g.axis_names == ("kl", "pr", "pc")
    assert g.devices.shape == (2, 2, 2) and g.devices.size == 8
    assert g.local_images() == list(range(8)) and g.home() == CPU
    assert [g.coords(i) for i in (0, 5, 7)] == [(0, 0, 0), (1, 0, 1), (1, 1, 1)]
    assert dict(_grid(6).shape) == {"kl": 1, "pr": 2, "pc": 3}
    # without devices: n images on the asked device
    assert make_grid(4, device="cpu").devices.size == 4
    assert make_grid(device="cpu").size == 1
    with pytest.raises(ValueError, match="requested"):
        make_grid(4, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="slots"):
        Grid((2, 2, 2), [(0, CPU)] * 4)


@pytest.mark.parametrize("nsplit,long_dim", [(8, "m"), (2, "m"), (1, "k"), (3, "n"),
                                             (4, "k")])
def test_optimize_grid_matches_jax(nsplit, long_dim):
    g, jm = _grid(8), jax_make_grid(8)
    got = optimize_grid(g, nsplit, long_dim)
    want = jax_optimize_grid(jm, nsplit, long_dim)
    assert dict(got.shape) == dict(want.shape)
    assert (got is g) == (want is jm)
    assert got.slots == g.slots  # the same images, re-factored


def test_optimize_grid_keeps_six_images_valid():
    g6 = _grid(6)
    for nsplit, ld in ((1, "m"), (6, "m"), (2, "k")):
        shape = optimize_grid(g6, nsplit, ld).shape
        assert shape["kl"] * shape["pr"] * shape["pc"] == 6
        assert dict(shape) == dict(jax_optimize_grid(jax_make_grid(6), nsplit, ld).shape)


def test_image_distribution_invariants_match_jax():
    d, jd = ImageDistribution(3, 2), JaxImages(3, 2)
    assert d.nimages == jd.nimages == 6
    blks = np.arange(25)
    layer, phys = d.split(blks)
    np.testing.assert_array_equal(layer, jd.split(blks)[0])
    np.testing.assert_array_equal(phys, jd.split(blks)[1])
    assert phys.max() < 3 and layer.max() < 2
    seen = np.concatenate([d.blocks_of_image(v, 25) for v in range(6)])
    assert sorted(seen.tolist()) == list(range(25))
    np.testing.assert_array_equal(d.image_of(blks), layer * 3 + phys)
    pair, jpair = make_image_dist(2, 3), jax_make_image_dist(2, 3)
    assert (pair.nimages, pair.multiplicity) == (jpair.nimages, jpair.multiplicity) == (6, 3)
    with pytest.raises(ValueError):
        ImageDistribution(0, 1)


def test_multihost_single_process_semantics():
    """The serial stub (ref `dbcsr_mpiwrap.F:130-150`): one process, the
    world grid equals the one-process grid."""
    assert process_count() == 1 and process_id() == 0 and is_coordinator()
    g = make_multihost_grid(images_per_process=8, device="cpu")
    assert set(g.axis_names) == {"kl", "pr", "pc"} and g.devices.size == 8
    assert dict(g.shape) == dict(jax_make_grid(8).shape)
    assert not g.multiprocess


def test_distribution_coordinates_and_fingerprint():
    grid = ProcessGrid(2, 3)
    d = Distribution(np.array([0, 1, 0]), np.array([2, 0, 1, 2]), grid)
    assert d.stored_coordinates(1, 0) == (1, 2)
    assert d.stored_coordinates(2, 1) == (0, 0)
    assert d.fingerprint() == d.checksum() == jdt.Distribution(
        np.array([0, 1, 0]), np.array([2, 0, 1, 2]), jdt.ProcessGrid(2, 3)).checksum()
    assert grid.nprocs == 6
    # the grid a product ran on rides along without changing equality
    assert ProcessGrid(2, 3, _grid(6)) == grid


# ----------------------------------------------------------- dense Cannon
@pytest.mark.parametrize("ndev,layers", [(1, None), (4, None), (8, None), (8, 8), (4, 4)])
def test_cannon_dense_matches_numpy_and_jax(ndev, layers):
    g = _grid(ndev, layers)
    s, kl = g.pr, g.kl
    rng = np.random.default_rng(0)
    m, k, n = 12 * s, 12 * kl * s, 8 * s
    a = rng.standard_normal((m, k))
    b = rng.standard_normal((k, n))
    got = cannon_multiply_dense(g, a, b)
    assert got.dtype == torch.float64 and got.device == CPU
    _close(got.numpy(), a @ b)
    _close(got.numpy(), np.asarray(jax_cannon(jax_make_grid(ndev, layers=layers), a, b)))


def test_cannon_float32():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((16, 32)).astype(np.float32)
    b = rng.standard_normal((32, 8)).astype(np.float32)
    got = cannon_multiply_dense(_grid(8), a, b)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(jax_cannon(jax_make_grid(8), a, b)), tol=1e-5)


def test_cannon_refuses_bad_shapes():
    with pytest.raises(ValueError, match="square"):
        cannon_multiply_dense(_grid(6), np.ones((6, 6)), np.ones((6, 6)))
    with pytest.raises(ValueError, match="divisible"):
        cannon_multiply_dense(_grid(4), np.ones((5, 4)), np.ones((4, 4)))
    with pytest.raises(ValueError, match="inner"):
        cannon_multiply_dense(_grid(4), np.ones((4, 4)), np.ones((6, 4)))


# ------------------------------------------------- distributed matrices
def _dist_product(mesh_n, rbs, kbs, cbs, occ, seed, alpha=1.0, beta=0.0, c_occ=None, **kw):
    rng = np.random.default_rng(seed)
    ja, pa = _pair("a", rbs, kbs, occ, rng, **kw)
    jb, pb = _pair("b", kbs, cbs, occ, rng)
    g, jm = _grid(mesh_n), jax_make_grid(mesh_n)
    if c_occ is None:
        pdc = multiply_distributed(alpha, distribute(pa, g, "A"), distribute(pb, g, "B"))
        jdc = jdt.parallel.multiply_distributed(alpha, jdt.parallel.distribute(ja, jm, "A"),
                                                jdt.parallel.distribute(jb, jm, "B"))
        want = alpha * (jax_tm.to_dense(ja) @ jax_tm.to_dense(jb))
    else:
        jc, pc = _pair("c", rbs, cbs, c_occ, rng)
        pdc = multiply_distributed(alpha, distribute(pa, g, "A"), distribute(pb, g, "B"),
                                   beta=beta, c=distribute(pc, g, "C"))
        jdc = jdt.parallel.multiply_distributed(
            alpha, jdt.parallel.distribute(ja, jm, "A"), jdt.parallel.distribute(jb, jm, "B"),
            beta=beta, c=jdt.parallel.distribute(jc, jm, "C"))
        want = alpha * (jax_tm.to_dense(ja) @ jax_tm.to_dense(jb)) + beta * jax_tm.to_dense(jc)
    got = collect(pdc)
    jgot = jdt.parallel.collect(jdc)
    assert np.array_equal(got.keys, jgot.keys)
    _close(port_tm.to_dense(got), want)
    _close(port_tm.to_dense(got), jax_tm.to_dense(jgot))
    return pa, pb, got


def test_distributed_multiply_uniform_blocks():
    _dist_product(8, [3] * 10, [3] * 14, [3] * 6, 0.4, 2, alpha=2.0)


def test_distributed_multiply_mixed_block_sizes():
    _dist_product(4, [2, 5, 3], [4, 2, 3, 5], [3, 2], 0.8, 3)


def test_distributed_beta_accumulate():
    _dist_product(8, [4] * 6, [4] * 6, [4] * 6, 0.5, 4, beta=0.5, c_occ=0.5)


def test_distributed_matches_single_device_engine():
    pa, pb, got = _dist_product(8, [3] * 8, [3] * 8, [3] * 8, 0.3, 5)
    c1 = port_tm.make_random_matrix("c", [3] * 8, [3] * 8, occupation=0.0, device="cpu")
    pdt.multiply("N", "N", 1.0, pa, pb, 0.0, c1)
    _close(port_tm.to_dense(got), port_tm.to_dense(c1))


def test_distributed_symmetric_input():
    _dist_product(4, [3] * 4, [3] * 4, [3] * 4, 1.0, 6, matrix_type="S")


def test_distributed_refuses_wrong_roles_and_grids():
    rng = np.random.default_rng(7)
    _, pa = _pair("a", [3] * 4, [3] * 4, 0.8, rng)
    g = _grid(4)
    with pytest.raises(ValueError, match="roles"):
        multiply_distributed(1.0, distribute(pa, g, "B"), distribute(pa, g, "B"))
    with pytest.raises(ValueError, match="different grids"):
        multiply_distributed(1.0, distribute(pa, g, "A"), distribute(pa, _grid(4), "B"))


def test_replicate_modes_row_col_full():
    """dbcsr_repl_row/col/full: each mode's collect reproduces the matrix
    bit for bit, and the layout names the JAX package's axes."""
    rng = np.random.default_rng(77)
    jm_, m = _pair("m", [3, 2, 3], [2, 3, 2], 0.9, rng)
    g, jmesh = _grid(8), jax_make_grid(8)
    want = port_tm.to_dense(m)
    for mode in ("full", "row", "col"):
        dm = replicate(m, g, mode=mode)
        np.testing.assert_array_equal(port_tm.to_dense(collect(dm, drop_zero_blocks=False)),
                                      want)
        jspec = jdt.parallel.replicate(jm_, jmesh, mode=mode).data.sharding.spec
        assert tuple(dm.spec) == tuple(jspec), (mode, dm.spec, jspec)
    with pytest.raises(ValueError, match="replication mode"):
        replicate(m, g, mode="diagonal")


def test_replicate_all_mesh():
    """`replicate_all` at the package root (ref dbcsr_replicate_all): the
    full matrix on every image; collecting it reproduces the matrix
    (`tests/test_api_parity.py:297`)."""
    rng = np.random.default_rng(41)
    _, m = _pair("m", [3, 2], [2, 3], 0.9, rng)
    dm = pdt.replicate_all(m, _grid(8))
    np.testing.assert_array_equal(port_tm.to_dense(collect(dm, drop_zero_blocks=False)),
                                  port_tm.to_dense(m))


def test_replicate_on_mesh():
    """`tests/test_csr_io.py:85`: replicate, then collect."""
    rng = np.random.default_rng(5)
    _, m = _pair("m", [2, 3], [2, 2], 1.0, rng)
    dm = replicate(m, _grid(8))
    np.testing.assert_array_equal(port_tm.to_dense(collect(dm)), port_tm.to_dense(m))


def test_mcweeny_step_distributed_matches_jax():
    """One dense-panel purification step on the grid (P in the A and B
    roles) against the JAX package's and against 3P² - 2P³."""
    from dbcsr_tpu.models.purify import make_test_density as jax_density
    from dbcsr_tpu.models.purify import mcweeny_step_distributed as jax_step

    from dbcsr_tpu_torch.models import mcweeny_step_distributed

    jp = jax_density(6, 3, seed=0)
    p = matrix_from_numpy_state(jax_state(jp), "cpu", name="P")
    g, jmesh = _grid(4), jax_make_grid(4)
    out = collect(mcweeny_step_distributed(distribute(p, g, "A"), distribute(p, g, "B")))
    jout = jdt.parallel.collect(jax_step(jdt.parallel.distribute(jp, jmesh, "A"),
                                         jdt.parallel.distribute(jp, jmesh, "B")))
    d = jax_tm.to_dense(jp)
    _close(port_tm.to_dense(out), 3 * d @ d - 2 * d @ d @ d)
    _close(port_tm.to_dense(out), jax_tm.to_dense(jout))


@pytest.mark.parametrize("n", [4, 8])
def test_mcweeny_step_sparse_distributed_matches_jax(n):
    from dbcsr_tpu.models.purify import make_test_density as jax_density
    from dbcsr_tpu.models.purify import mcweeny_step_sparse_distributed as jax_step

    from dbcsr_tpu_torch.models import mcweeny_step, mcweeny_step_sparse_distributed

    jp = jax_density(8, 3, seed=1)
    p = matrix_from_numpy_state(jax_state(jp), "cpu", name="P")
    out = mcweeny_step_sparse_distributed(p, _grid(n), filter_eps=1e-9)
    jout = jax_step(jp, jax_make_grid(n), filter_eps=1e-9)
    assert np.array_equal(out.keys, jout.keys)
    _close(port_tm.to_dense(out), jax_tm.to_dense(jout))
    _close(port_tm.to_dense(out), port_tm.to_dense(mcweeny_step(p.copy(), filter_eps=1e-9)))
