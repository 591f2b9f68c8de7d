"""The port's block-sparse tensor layer held against the JAX package on
the CPU.

The cases of `tests/test_tensor.py` (after
`dbcsr_tensor_unittest.F:101-300`), the 3-center RI contraction of the
water system at 8 molecules, the tensor state carried across packages,
and the matrix, chain and timer pieces the layer calls.  Each tensor is
drawn by the JAX package from a numpy seed and carried to the port with
`dbcsr_tpu_torch.interop.tensor_from_numpy_state`; both packages then
run the same remap, copy, restriction or contraction, the port's K1
wrapper on its plain version (CPU tensors), the JAX package on its
"xla" driver.  The mesh cases run the JAX package on its forced
8-device CPU mesh and the port on a grid of CPU images.

Tolerances: block index sets equal; remaps and copies bit for bit;
contractions relative to max |C| within 1e-12 of the JAX package's and
of the einsum oracle (f64), `kernel_validation_tolerance` (f32).
"""

import itertools

import numpy as np
import pytest
import torch

from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.models import purify as jax_purify
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.tensor import batched_contraction as jax_batched_contraction
from dbcsr_tpu.tensor import contract as jax_contract
from dbcsr_tpu.tensor import create_tensor as jax_create_tensor
from dbcsr_tpu.tensor import remap as jax_remap
from dbcsr_tpu.tensor import restrict_tensor as jax_restrict
from dbcsr_tpu.tensor import split_blocks as jax_split_blocks
from dbcsr_tpu.tensor import tensor_copy as jax_tensor_copy

from dbcsr_tpu_torch.core import mempool, timings
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.interop import (
    matrix_from_numpy_state,
    tensor_from_numpy_state,
    tensor_to_numpy_state,
)
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.models import make_test_density
from dbcsr_tpu_torch.obs.costmodel import kernel_validation_tolerance
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.tensor import (
    BlockSparseTensor,
    batched_contract_finalize,
    batched_contract_init,
    batched_contraction,
    contract,
    contract_test,
    copy_matrix_to_tensor,
    copy_tensor_to_matrix,
    create_tensor,
    remap,
    restrict_tensor,
    split_blocks,
    tensor_copy,
)


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


def jax_tensor_state(t) -> dict:
    """The interop state of a JAX tensor, blocks in its key order."""
    return {"blk_sizes": t.blk_sizes, "row_dims": t.row_dims, "col_dims": t.col_dims,
            "dtype": jax_enum_of(t.dtype), "indices": t.entry_multi_coords(),
            "blocks": [blk for _, blk in t.iterate_blocks()]}


def _rand(name, blk_sizes, occ, row_dims=None, col_dims=None, seed=0, dtype=np.float64):
    """(JAX, port) tensors with the same blocks, drawn as
    `tests/test_tensor.py` draws them."""
    rng = np.random.default_rng(seed)
    t = jax_create_tensor(name, blk_sizes, row_dims, col_dims, dtype=dtype)
    for idx in itertools.product(*(range(len(n)) for n in blk_sizes)):
        if rng.random() < occ:
            t.put_block(idx, rng.standard_normal(t.block_shape(idx)).astype(dtype))
    t.finalize()
    return t, tensor_from_numpy_state(jax_tensor_state(t), "cpu", name=name)


def _empty(name, blk_sizes, row_dims=None, col_dims=None, dtype=np.float64):
    jt = jax_create_tensor(name, blk_sizes, row_dims, col_dims, dtype=dtype)
    pt = create_tensor(name, blk_sizes, row_dims, col_dims, dtype=dtype, device="cpu")
    return jt.finalize(), pt.finalize()


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want), initial=0.0)) / max(
        float(np.max(np.abs(want), initial=0.0)), 1.0)


def _same(pt, jt, tol=0.0, oracle=None):
    """The port's tensor against the JAX package's: the mapping, the block
    index set and the values (bit for bit when ``tol`` is 0)."""
    assert (pt.row_dims, pt.col_dims) == (tuple(jt.row_dims), tuple(jt.col_dims))
    assert sorted(map(tuple, pt.block_indices())) == sorted(map(tuple, jt.block_indices()))
    got, want = pt.to_dense(), np.asarray(jt.to_dense())
    if tol == 0.0:
        assert np.array_equal(got, want)
    else:
        assert _rel(got, want) <= tol
    if oracle is not None:
        assert _rel(got, oracle) <= max(tol, 1e-12)


def test_put_get_roundtrip_rank3():
    t = create_tensor("t", [[2, 3], [4, 2], [3]], (0,), (1, 2), device="cpu")
    blk = np.random.default_rng(0).standard_normal((3, 2, 3))
    t.put_block((1, 1, 0), blk)
    with pytest.raises(ValueError, match="shape"):
        t.put_block((0, 0, 0), blk)
    t.finalize()
    np.testing.assert_array_equal(t.get_block((1, 1, 0)), blk)
    assert t.get_block((0, 0, 0)) is None
    assert t.block_indices() == [(1, 1, 0)]
    with pytest.raises(ValueError, match="partition"):
        BlockSparseTensor("x", [[2], [2]], (0,), (0,), device="cpu")


@pytest.mark.parametrize("mapping", [((0,), (1, 2)), ((1,), (0, 2)),
                                     ((0, 1), (2,)), ((2, 0), (1,))])
def test_formats_carry_identical_blocks(mapping):
    """ref dbcsr_t_test_formats: one tensor in several nd->2d mappings
    holds identical blocks, in both packages."""
    sizes = [[2, 3], [4, 2], [3, 2]]
    j0, p0 = _rand("t0", sizes, occ=0.7, seed=1)
    j1, p1 = jax_remap(j0, *mapping), remap(p0, *mapping)
    _same(p1, j1)
    for idx, blk in p0.iterate_blocks():
        np.testing.assert_array_equal(p1.get_block(idx), blk)
    np.testing.assert_array_equal(p0.to_dense(), p1.to_dense())
    assert remap(p1, *mapping) is p1  # the same mapping is no remap


def test_tensor_copy_between_mappings():
    sizes = [[2, 2], [3], [2, 4]]
    js, ps = _rand("s", sizes, occ=0.8, row_dims=(0, 1), col_dims=(2,), seed=2)
    jd, pd = _empty("d", sizes, (2,), (1, 0))
    jax_tensor_copy(jd, js)
    tensor_copy(pd, ps)
    _same(pd, jd)
    np.testing.assert_array_equal(pd.to_dense(), ps.to_dense())


def test_tensor_copy_summation_and_preserved_blocks():
    """summation adds into overlapping dest blocks; blocks only in dest
    survive an overwriting copy."""
    sizes = [[2, 2], [3], [2, 4]]
    js, ps = _rand("s", sizes, occ=0.6, row_dims=(0, 1), col_dims=(2,), seed=7)
    jb, pb = _rand("d", sizes, occ=0.6, row_dims=(2,), col_dims=(1, 0), seed=8)
    for summation in (True, False):
        jd, pd = _empty("d", sizes, (2,), (1, 0))
        jax_tensor_copy(jd, jb)
        tensor_copy(pd, pb)
        jax_tensor_copy(jd, js, summation=summation)
        tensor_copy(pd, ps, summation=summation)
        _same(pd, jd)
        if summation:
            np.testing.assert_allclose(pd.to_dense(), pb.to_dense() + ps.to_dense(),
                                       rtol=1e-13, atol=1e-13)


def test_tensor_copy_rejects_mismatched_blockings():
    """Per-dim blockings that flatten to the same matrix block shape are
    still rejected (the data would be silently reinterpreted)."""
    src = create_tensor("s", [[2], [3]], (0, 1), (), device="cpu")
    src.put_block((0, 0), np.arange(6.0).reshape(2, 3))
    src.finalize()
    dst = create_tensor("d", [[3], [2]], (0, 1), (), device="cpu")
    with pytest.raises(ValueError, match="blockings differ"):
        tensor_copy(dst, src)
    with pytest.raises(ValueError, match="shapes differ"):
        tensor_copy(create_tensor("e", [[2], [3], [1]], device="cpu"), src)


def test_rank4_remap_roundtrip():
    """A rank-4 remap across disjoint mappings is an exact bijection."""
    sizes = [[2, 3], [2], [3, 2], [2, 2]]
    j0, p0 = _rand("t4", sizes, occ=0.5, row_dims=(0, 1), col_dims=(2, 3), seed=9)
    p1 = remap(p0, (3, 1), (0, 2))
    p2 = remap(p1, (0, 1), (2, 3))
    _same(p1, jax_remap(j0, (3, 1), (0, 2)))
    np.testing.assert_array_equal(p0.to_dense(), p1.to_dense())
    _same(p2, j0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_contract_rank3_with_matrix(dtype):
    """T(i,j,k) * M(k,l) -> C(i,j,l), the 3-center integral pattern."""
    si, sj, sk, sl = [2, 3], [3, 2], [4, 2], [2, 2]
    ja, pa = _rand("a", [si, sj, sk], occ=0.8, seed=3, dtype=dtype)
    jb, pb = _rand("b", [sk, sl], occ=0.9, seed=4, dtype=dtype)
    jc, pc = _empty("c", [si, sj, sl], dtype=dtype)
    kw = dict(contract_a=(2,), notcontract_a=(0, 1), contract_b=(0,),
              notcontract_b=(1,), map_1=(0, 1), map_2=(2,))
    jf = jax_contract(1.0, ja, jb, 0.0, jc, **kw)
    pf = contract(1.0, pa, pb, 0.0, pc, **kw)
    assert pf == jf and pc.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    want = np.einsum("ijk,kl->ijl", ja.to_dense().astype(np.float64),
                     jb.to_dense().astype(np.float64))
    tol = 1e-12 if dtype == np.float64 else kernel_validation_tolerance("float32", 6, 2)
    _same(pc, jc, tol, want)


def test_contract_rank3_rank3_over_two_dims():
    """A(i,a,b) * B(j,a,b) -> C(i,j) (RPA-like double contraction)."""
    si, sj, sa, sb = [2, 2], [3], [2, 3], [2, 2]
    ja, pa = _rand("a", [si, sa, sb], occ=0.9, seed=5)
    jb, pb = _rand("b", [sj, sa, sb], occ=0.9, seed=6)
    jc, pc = _empty("c", [si, sj])
    kw = dict(contract_a=(1, 2), notcontract_a=(0,), contract_b=(1, 2),
              notcontract_b=(0,), map_1=(0,), map_2=(1,))
    jax_contract(1.0, ja, jb, 0.0, jc, **kw)
    contract(1.0, pa, pb, 0.0, pc, **kw)
    _same(pc, jc, 1e-12, np.einsum("iab,jab->ij", ja.to_dense(), jb.to_dense()))


def test_contract_beta_and_alpha():
    si, sk = [2, 3], [3, 2]
    ja, pa = _rand("a", [si, sk], occ=1.0, seed=7)
    jb, pb = _rand("b", [sk, si], occ=1.0, seed=8)
    jc, pc = _rand("c", [si, si], occ=0.5, seed=9)
    c0 = pc.to_dense()
    kw = dict(contract_a=(1,), notcontract_a=(0,), contract_b=(0,), notcontract_b=(1,))
    jax_contract(2.0, ja, jb, 0.5, jc, **kw)
    contract(2.0, pa, pb, 0.5, pc, **kw)
    _same(pc, jc, 1e-12, 2.0 * pa.to_dense() @ pb.to_dense() + 0.5 * c0)


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_contract_into_nonstandard_c_mapping(beta):
    """C stored with another mapping than the contraction layout: the
    product lands in a temporary and is copied over with summation."""
    si, sj, sk = [2, 2], [3, 2], [2, 3]
    ja, pa = _rand("a", [si, sk], occ=1.0, seed=10)
    jb, pb = _rand("b", [sk, sj], occ=1.0, seed=11)
    jc, pc = _rand("c", [si, sj], occ=0.5, row_dims=(1,), col_dims=(0,), seed=12)
    c0 = pc.to_dense()
    kw = dict(contract_a=(1,), notcontract_a=(0,), contract_b=(0,), notcontract_b=(1,))
    jax_contract(1.0, ja, jb, beta, jc, **kw)
    contract(1.0, pa, pb, beta, pc, **kw)
    _same(pc, jc, 1e-12, pa.to_dense() @ pb.to_dense() + beta * c0)


def test_contract_rank4():
    """A(i,j,a,b) * B(a,b,k,l) -> C(i,j,k,l)."""
    s = [2, 2]
    ja, pa = _rand("a", [s, s, s, s], occ=0.6, seed=12)
    jb, pb = _rand("b", [s, s, s, s], occ=0.6, seed=13)
    jc, pc = _empty("c", [s, s, s, s])
    kw = dict(contract_a=(2, 3), notcontract_a=(0, 1), contract_b=(0, 1),
              notcontract_b=(2, 3), map_1=(0, 1), map_2=(2, 3))
    jax_contract(1.0, ja, jb, 0.0, jc, **kw)
    contract(1.0, pa, pb, 0.0, pc, **kw)
    _same(pc, jc, 1e-12, np.einsum("ijab,abkl->ijkl", ja.to_dense(), jb.to_dense()))


def test_contract_validates_arguments():
    _, pa = _rand("a", [[2], [3]], occ=1.0, seed=14)
    _, pb = _rand("b", [[4], [2]], occ=1.0, seed=15)
    _, pc = _empty("c", [[2], [2]])
    with pytest.raises(ValueError, match="blockings differ"):
        contract(1.0, pa, pb, 0.0, pc, (1,), (0,), (0,), (1,))
    with pytest.raises(ValueError, match="partition A"):
        contract(1.0, pa, pb, 0.0, pc, (1,), (1,), (0,), (1,))
    with pytest.raises(ValueError, match="counts differ"):
        contract(1.0, pa, pa, 0.0, pc, (1,), (0,), (), (0, 1))


def test_contract_with_bounds():
    """bounds restrict the contraction to block-index ranges: the einsum of
    the cropped operands."""
    si, sj, sk = [2, 3, 2], [3, 2, 4], [4, 2, 3]
    koff = np.concatenate([[0], np.cumsum(sk)])
    ja, pa = _rand("a2", [si, sk], occ=0.9, seed=13)
    jb, pb = _rand("b2", [sk, sj], occ=0.9, seed=14)
    kw = dict(contract_a=(1,), notcontract_a=(0,), contract_b=(0,), notcontract_b=(1,))
    for bounds in (dict(bounds_1=[(1, 2)]), dict(bounds_2=[(0, 1)], bounds_3=[(1, 2)])):
        jc, pc = _empty("c2", [si, sj])
        jax_contract(1.0, ja, jb, 0.0, jc, **kw, **bounds)
        contract(1.0, pa, pb, 0.0, pc, **kw, **bounds)
        _same(pc, jc, 1e-12)
    ad, bd = pa.to_dense().copy(), pb.to_dense().copy()
    ad[:, : koff[1]] = 0
    bd[: koff[1], :] = 0
    jc, pc = _empty("c2", [si, sj])
    contract(1.0, pa, pb, 0.0, pc, **kw, bounds_1=[(1, 2)])
    assert _rel(pc.to_dense(), ad @ bd) <= 1e-12
    with pytest.raises(ValueError, match="bounds length"):
        contract(1.0, pa, pb, 0.0, pc, **kw, bounds_1=[(1, 2), (0, 0)])


def test_batched_contract_accumulates_chunks():
    """Chunking the contracted dim over bounds inside a batched context
    reproduces the full contraction, the filter deferred to the end."""
    si, sk, sj = [2, 3], [3, 2, 4, 2], [2, 3]
    ja, pa = _rand("a", [si, sk], occ=1.0, seed=21)
    jb, pb = _rand("b", [sk, sj], occ=1.0, seed=22)
    jc, pc = _empty("c", [si, sj])
    kw = dict(contract_a=(1,), notcontract_a=(0,), contract_b=(0,), notcontract_b=(1,),
              filter_eps=1e-12)
    with jax_batched_contraction(jc):
        for k0 in range(len(sk)):
            jax_contract(1.0, ja, jb, 1.0, jc, bounds_1=[(k0, k0)], **kw)
    with batched_contraction(pc) as t:
        assert t is pc and pc.matrix._tas_batched_state is not None
        for k0 in range(len(sk)):
            contract(1.0, pa, pb, 1.0, pc, bounds_1=[(k0, k0)], **kw)
        assert pc._batched_state["filter_eps"] == 1e-12
    assert pc._batched_state is None and pc.matrix._tas_batched_state is None
    _same(pc, jc, 1e-12, pa.to_dense() @ pb.to_dense())
    with pytest.raises(RuntimeError, match="not in a batched"):
        batched_contract_finalize(pc)
    batched_contract_init(pc, nsplit=2)
    with pytest.raises(RuntimeError, match="already"):
        batched_contract_init(pc)
    batched_contract_finalize(pc)


def test_restrict_tensor_drops_out_of_range_blocks():
    sizes = [[2, 3, 2], [3, 2], [2, 2, 3]]
    jt, pt = _rand("t", sizes, occ=1.0, seed=31)
    r = restrict_tensor(pt, {0: (1, 2), 2: (0, 1)})
    _same(r, jax_restrict(jt, {0: (1, 2), 2: (0, 1)}))
    nd = r.entry_multi_coords()
    assert len(nd) and (nd[:, 0] >= 1).all() and (nd[:, 2] <= 1).all()
    for idx, blk in r.iterate_blocks():
        np.testing.assert_array_equal(pt.get_block(idx), blk)
    assert restrict_tensor(pt, {0: None}) is pt  # no restriction shares the tensor
    named = restrict_tensor(pt, {}, name="copy")
    assert named is not pt and named.name == "copy"
    _same(named, jt)


def test_tensor_api_parity_surface():
    import io as _io

    rng = np.random.default_rng(17)
    t = create_tensor("t", [[2, 3], [3, 2], [2, 2]], device="cpu")
    t.reserve_blocks([[0, 0, 0], [1, 1, 1]])
    assert t.nblks == 2
    t.put_block([0, 1, 0], rng.standard_normal((2, 2, 2)))
    t.finalize()
    t.set_value(2.0)
    assert np.allclose(t.get_block([0, 1, 0]), 2.0)
    t.scale(0.5)
    assert np.allclose(t.get_block([0, 1, 0]), 1.0)
    info = t.get_info()
    assert info["ndim"] == 3 and info["nblks"] == 3 and info["data_type"] == "float64"
    assert t.get_nze() == 12 + 12 + 8  # (2,3,2) + (3,2,2) + (2,2,2)
    assert t.get_num_blocks() == 3
    mi = t.get_mapping_info()
    assert mi["dims_2d"] == (t.matrix.nblkrows, t.matrix.nblkcols)
    assert abs(t.checksum() - 32.0) < 1e-12
    assert t.get_stored_coordinates([0, 0, 0]) == (0, 0)
    assert t.blk_sizes_of([1, 0, 1]) == (3, 3, 2)
    buf = _io.StringIO()
    t.write_blocks(buf)
    assert "block (0, 0, 0)" in buf.getvalue()
    buf2 = _io.StringIO()
    t.write_split_info(buf2)
    assert "2d grid" in buf2.getvalue()
    t.filter(1e30)
    assert t.nblks == 0
    t.clear()
    assert t.nblks == 0 and t.matrix.valid
    with pytest.raises(ValueError, match="indices"):
        t.reserve_blocks([[0, 0]])


def test_tensor_split_blocks():
    rng = np.random.default_rng(18)
    jt = jax_create_tensor("t", [[4, 2], [3, 3]])
    for idx, shape in (([0, 0], (4, 3)), ([1, 1], (2, 3))):
        jt.put_block(idx, rng.standard_normal(shape))
    jt.finalize()
    pt = tensor_from_numpy_state(jax_tensor_state(jt), "cpu")
    s = split_blocks(pt, [[2, 2, 2], [3, 1, 2]])
    _same(s, jax_split_blocks(jt, [[2, 2, 2], [3, 1, 2]]))
    np.testing.assert_allclose(s.to_dense(), pt.to_dense())
    assert s.nblks > pt.nblks
    with pytest.raises(ValueError):
        split_blocks(pt, [[3, 3], [3, 3]])  # breaks an old boundary


def test_tensor_matrix_copies():
    rng = np.random.default_rng(19)
    jm = jax_tm.make_random_matrix("m", [2, 3], [3, 2], occupation=0.8, rng=rng)
    m = matrix_from_numpy_state({
        "row_blk_sizes": jm.row_blk_sizes, "col_blk_sizes": jm.col_blk_sizes,
        "matrix_type": "N", "dtype": 3, "keys": jm.keys, "ent_bin": jm.ent_bin,
        "ent_slot": jm.ent_slot,
        "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in jm.bins]},
        "cpu")
    t = create_tensor("t", [[2, 3], [3, 2]], row_dims=(0,), col_dims=(1,), device="cpu")
    copy_matrix_to_tensor(m, t)
    np.testing.assert_array_equal(t.to_dense(), jax_tm.to_dense(jm))
    m2 = BlockSparseMatrix("m2", [2, 3], [3, 2], device="cpu")
    copy_tensor_to_matrix(t, m2)
    np.testing.assert_array_equal(port_tm.to_dense(m2), jax_tm.to_dense(jm))
    with pytest.raises(ValueError, match="blockings differ"):
        copy_tensor_to_matrix(t, BlockSparseMatrix("m3", [5], [5], device="cpu"))
    # a symmetric matrix arrives desymmetrized
    s = port_tm.make_random_matrix("s", [2, 3], [2, 3], occupation=0.9, matrix_type="S",
                                   rng=np.random.default_rng(3), device="cpu")
    ts = create_tensor("ts", [[2, 3], [2, 3]], device="cpu")
    copy_matrix_to_tensor(s, ts)
    np.testing.assert_array_equal(ts.to_dense(), port_tm.to_dense(s))


def test_contract_test_harness():
    """dbcsr_t_contract_test analog: contraction vs dense einsum oracle."""
    rng = np.random.default_rng(21)
    a = create_tensor("a", [[2, 3], [3], [2, 2]], device="cpu")
    b = create_tensor("b", [[3], [2, 2], [4]], device="cpu")
    c = create_tensor("c", [[2, 3], [2, 2], [2, 2], [4]], device="cpu")
    for t in (a, b):
        for idx in np.ndindex(*t.nblks_per_dim):
            if rng.random() < 0.7:
                t.put_block(list(idx), rng.standard_normal(t.block_shape(idx)))
        t.finalize()
    c.finalize()
    msgs = []
    assert contract_test(2.0, a, b, 0.0, c, [1], [0, 2], [0], [1, 2], io=msgs.append)
    assert msgs and "OK" in msgs[0]
    msgs.clear()
    assert not contract_test(2.0, a, b, 0.0, c, [1], [0, 2], [0], [1, 2], eps=-1.0,
                             io=msgs.append)
    assert "FAILED" in msgs[0]


def test_contract_test_with_bounds_and_filter_reject():
    si, sk, sj = [2, 3, 2], [4, 2, 3], [3, 2]
    _, pa = _rand("a", [si, sk], occ=0.9, seed=23)
    _, pb = _rand("b", [sk, sj], occ=0.9, seed=24)
    _, pc = _empty("c", [si, sj])
    assert contract_test(1.0, pa, pb, 0.0, pc, [1], [0], [0], [1],
                         bounds_1=[(1, 2)], io=lambda *_: None)
    assert contract_test(1.0, pa, pb, 0.0, pc, [1], [0], [0], [1],
                         bounds_2=[(0, 1)], bounds_3=[(1, 1)], io=lambda *_: None)
    with pytest.raises(ValueError, match="filter_eps"):
        contract_test(1.0, pa, pb, 0.0, pc, [1], [0], [0], [1],
                      filter_eps=1e-10, io=lambda *_: None)


def test_contract_on_a_mesh_raises():
    """A mesh that is not a `parallel` grid raises; nothing runs."""
    _, pa = _rand("a", [[2], [3]], occ=1.0, seed=25)
    _, pb = _rand("b", [[3], [2]], occ=1.0, seed=26)
    _, pc = _empty("c", [[2], [2]])
    with pytest.raises(TypeError, match="Grid"):
        contract(1.0, pa, pb, 0.0, pc, (1,), (0,), (0,), (1,), mesh=object())
    assert pc.matrix.nblks == 0


def _grids(n, layers=None):
    from dbcsr_tpu.parallel import make_grid as jax_make_grid

    from dbcsr_tpu_torch.parallel import make_grid

    return jax_make_grid(n, layers=layers), make_grid(n, devices=["cpu"] * n, layers=layers)


_RI_KW = dict(contract_a=(2,), notcontract_a=(0, 1), contract_b=(0,), notcontract_b=(1,),
              map_1=(0, 1), map_2=(2,))


@pytest.mark.parametrize("n", [8, 6], ids=["2x2x2", "1x2x3"])
def test_contract_rank3_mesh_matches_jax(n):
    """`tests/test_tensor.py:135` and `:451`: a rank-3 contraction routed
    over a grid (square: the grouped TAS Cannons; rectangular: the
    all-gather engine) against the JAX package's on its mesh, the
    einsum oracle and the single-device contraction."""
    si, sj, sk, sl = [2, 3] * 4, [3, 2] * 3, [4, 2] * 2, [2, 2]
    ja, pa = _rand("a", [si, sj, sk], occ=0.5, seed=30)
    jb, pb = _rand("b", [sk, sl], occ=0.8, seed=31)
    jc, pc = _empty("cm", [si, sj, sl])
    _, ph = _empty("ch", [si, sj, sl])
    jm, pm = _grids(n)
    jf = jax_contract(1.0, ja, jb, 0.0, jc, mesh=jm, **_RI_KW)
    pf = contract(1.0, pa, pb, 0.0, pc, mesh=pm, **_RI_KW)
    contract(1.0, pa, pb, 0.0, ph, **_RI_KW)
    assert pf == jf
    want = np.einsum("ijk,kl->ijl", ja.to_dense(), jb.to_dense())
    _same(pc, jc, 1e-12, want)
    assert _rel(pc.to_dense(), ph.to_dense()) <= 1e-12


def test_contract_rank3_rank3_mesh_double_contraction_matches_jax():
    """`tests/test_tensor.py:162`: A(i,a,b) * B(j,a,b) -> C(i,j) over the
    grid, with alpha and beta."""
    si, sj, sa, sb = [2, 2] * 3, [3] * 4, [2, 3] * 2, [2, 2]
    ja, pa = _rand("a", [si, sa, sb], occ=0.6, seed=32)
    jb, pb = _rand("b", [sj, sa, sb], occ=0.6, seed=33)
    jc, pc = _rand("c", [si, sj], occ=0.4, seed=34)
    before = jc.to_dense().copy()
    jm, pm = _grids(8)
    kw = dict(contract_a=(1, 2), notcontract_a=(0,), contract_b=(1, 2),
              notcontract_b=(0,), map_1=(0,), map_2=(1,))
    jax_contract(2.0, ja, jb, 0.5, jc, mesh=jm, **kw)
    contract(2.0, pa, pb, 0.5, pc, mesh=pm, **kw)
    want = 2.0 * np.einsum("iab,jab->ij", ja.to_dense(), jb.to_dense()) + 0.5 * before
    _same(pc, jc, 1e-12, want)


def test_contract_pipeline_on_a_rect_grid_is_bitwise_across_repeats():
    """`tests/test_contract_pipeline.py:96`: the same contraction on a
    1x2x3 grid twice, plans cleared between, gives the same bits, and
    its grid multiply is on the flight record."""
    from dbcsr_tpu_torch.obs import flight
    from dbcsr_tpu_torch.parallel.sparse_dist import clear_mesh_plans

    si, sj, sk, sl = [2, 3] * 3, [3, 2] * 2, [4, 2] * 2, [2, 2]
    _, pa = _rand("a", [si, sj, sk], occ=0.6, seed=40)
    _, pb = _rand("b", [sk, sl], occ=0.9, seed=41)
    _, pm = _grids(6, layers=1)
    outs = []
    for _ in range(2):
        clear_mesh_plans()
        _, pc = _empty("c", [si, sj, sl])
        contract(1.0, pa, pb, 0.0, pc, mesh=pm, **_RI_KW)
        outs.append(pc)
    assert np.array_equal(outs[0].to_dense(), outs[1].to_dense())
    rec = [r for r in flight.records() if r.get("op") == "mesh_multiply"][-1]
    assert rec["cannon_mode"] == "double_buffer"


def test_tensor_numpy_state_round_trip():
    """A JAX tensor's state builds the same tensor in the port, in any
    mapping, and the port's state gives it back."""
    sizes = [[2, 3], [4, 2], [3, 2]]
    j0, p0 = _rand("t0", sizes, occ=0.7, row_dims=(2,), col_dims=(0, 1), seed=27)
    _same(p0, j0)
    st = tensor_to_numpy_state(p0)
    assert st["dtype"] == 3 and (st["row_dims"], st["col_dims"]) == ((2,), (0, 1))
    back = tensor_from_numpy_state(st, "cpu", name="back")
    _same(back, j0)
    for idx, blk in zip(st["indices"], st["blocks"]):
        np.testing.assert_array_equal(j0.get_block(tuple(idx)), blk)
    bad = dict(st, blocks=st["blocks"][:-1])
    with pytest.raises(ValueError, match="blocks for"):
        tensor_from_numpy_state(bad, "cpu")
    empty = tensor_from_numpy_state(dict(st, indices=np.empty((0, 3)), blocks=[]), "cpu")
    assert empty.nblks == 0 and empty.matrix.valid


# ------------------------------------------------ the slice as a whole
def _ri_indices(d_rows, d_cols):
    """T(mu, nu, P) exists where the pair pattern D has (mu, nu) and (mu, P):
    the 3-center pattern of the smoke's ``tensor`` phase."""
    out = []
    for mu in np.unique(d_rows):
        s = d_cols[d_rows == mu]
        out.append(np.stack([np.full(len(s) ** 2, mu), np.repeat(s, len(s)),
                             np.tile(s, len(s))], axis=1))
    return np.concatenate(out).astype(np.int64)


def test_ri_contraction_of_the_water_system_matches_jax():
    """(mu nu|P) M(P,Q) -> (mu nu|Q) at 8 molecules of 23 orbitals: the
    smoke's full-width phase cut in depth.  The density's pattern from
    `make_test_density`, identical in both packages; T's blocks drawn with
    numpy; the split chosen by the estimate (nsplit > 1)."""
    nmol, blk = 8, 23
    jd = jax_purify.make_test_density(nmol, blk, occ=0.2, seed=0)
    pd = make_test_density(nmol, blk, occ=0.2, seed=0, device="cpu")
    assert np.array_equal(pd.keys, jd.keys)
    rows, cols = pd.entry_coords()
    idx = _ri_indices(rows, cols)
    rng = np.random.default_rng(2026)
    sizes = [[blk] * nmol] * 3
    jt = jax_create_tensor("T", sizes, (0, 1), (2,))
    jt.reserve_blocks(idx)
    blocks = rng.standard_normal((len(idx), blk, blk, blk))
    for i, b in zip(idx, blocks):
        jt.put_block(tuple(i), b)
    jt.finalize()
    pt = tensor_from_numpy_state(jax_tensor_state(jt), "cpu", name="T")
    jm = jax_create_tensor("M", sizes[:2], (0,), (1,))
    for r, c, b in jd.iterate_blocks():
        jm.put_block((r, c), np.asarray(b))
    jm.finalize()
    pm = create_tensor("M", sizes[:2], (0,), (1,), device="cpu")
    copy_matrix_to_tensor(pd, pm)
    _same(pm, jm)
    jc, pc = _empty("C", sizes, (0, 1), (2,))
    kw = dict(contract_a=(2,), notcontract_a=(0, 1), contract_b=(0,),
              notcontract_b=(1,), map_1=(0, 1), map_2=(2,))
    mm.reset_totals()
    jf = jax_contract(1.0, jt, jm, 0.0, jc, **kw)
    pf = contract(1.0, pt, pm, 0.0, pc, **kw)
    totals = mm.read_totals()
    assert pf == jf
    assert pc.matrix._tas_nsplit > 1
    nsplit, nrows = pc.matrix._tas_nsplit, pc.matrix.nblkrows
    assert totals["multiplies"] == len(range(0, nrows, -(-nrows // nsplit)))  # the groups
    # one expansion a group, and one for C's pattern built before them
    assert totals["c_rebuild"] == {"rebuilt": 0, "kept": totals["multiplies"], "prebuilt": 1}
    assert totals["index_engine"]["expand"]["native"] + totals["index_engine"]["expand"]["numpy"] \
        == totals["multiplies"] + 1
    assert all(k.startswith("stack:") for k in totals["formats"])
    want = np.einsum("abc,cd->abd", jt.to_dense(), jm.to_dense())
    _same(pc, jc, 1e-12, want)
    assert abs(pc.checksum() - jc.checksum()) <= 1e-12 * abs(jc.checksum())


# ------------------------------------ matrix, chain and timer pieces
def test_stage_device_blocks_merges_at_finalize():
    rng = np.random.default_rng(30)
    m = BlockSparseMatrix("m", [2, 3, 2], [3, 3], device="cpu")
    m.put_block(0, 0, np.ones((2, 3)))
    m.finalize()
    blocks = torch.from_numpy(rng.standard_normal((2, 2, 3)))
    m.stage_device_blocks([0, 2], [0, 1], blocks)
    assert not m.valid
    m.finalize()
    np.testing.assert_array_equal(m.get_block(0, 0), blocks[0].numpy())
    np.testing.assert_array_equal(m.get_block(2, 1), blocks[1].numpy())
    m.stage_device_blocks([0], [0], blocks[:1], summation=True)
    m2 = m.copy()  # a pending device batch is copied, not shared
    m.finalize()
    np.testing.assert_array_equal(m.get_block(0, 0), 2 * blocks[0].numpy())
    m2.finalize()
    np.testing.assert_array_equal(m2.get_block(0, 0), 2 * blocks[0].numpy())
    with pytest.raises(ValueError, match="does not match"):
        m.stage_device_blocks([1], [0], blocks[:1])
    with pytest.raises(IndexError):
        m.stage_device_blocks([3], [0], blocks[:1])
    with pytest.raises(ValueError, match="mismatch"):
        m.stage_device_blocks([0, 2], [0], blocks)
    s = BlockSparseMatrix("s", [2], [2], matrix_type="S", device="cpu")
    with pytest.raises(NotImplementedError):
        s.stage_device_blocks([0], [0], torch.zeros((1, 2, 2), dtype=torch.float64))


def test_stage_device_blocks_invalidates_the_canvas_cache():
    """A finalize of staged device blocks writes new bins: the dense
    format's canvas cache must not serve the old values."""
    m = BlockSparseMatrix("m", [2, 2], [2, 2], device="cpu")
    m.put_block(0, 0, np.ones((2, 2)))
    m.finalize()
    before = mm._dense_canvas_cached(m).clone()
    m.stage_device_blocks([0], [0], torch.full((1, 2, 2), 3.0, dtype=torch.float64),
                          summation=True)
    m.finalize()
    after = mm._dense_canvas_cached(m)
    assert float(before[0, 0]) == 1.0 and float(after[0, 0]) == 4.0


def test_get_blocks_reserve_block_get_info_setname():
    rng = np.random.default_rng(31)
    m = port_tm.make_random_matrix("m", [2, 3, 4], [3, 2], occupation=0.7, rng=rng,
                                   device="cpu")
    rows, cols = np.array([0, 1, 2, 2]), np.array([0, 1, 0, 1])
    got = m.get_blocks(rows, cols)
    for r, c, g in zip(rows, cols, got):
        want = m.get_block(r, c)
        assert (g is None and want is None) or np.array_equal(g, want)
    absent = [(r, c) for r in range(3) for c in range(2) if m.get_block(r, c) is None]
    r0, c0 = absent[0] if absent else (0, 0)
    m.reserve_block(r0, c0)
    m.finalize()
    np.testing.assert_array_equal(m.get_block(r0, c0), np.zeros(m.block_shape(r0, c0)))
    info = m.get_info()
    assert info["nblks"] == m.nblks and info["nze"] == m.nnz == info["data_size"]
    assert info["data_type"] == "float64" and info["nfullrows_total"] == 9
    m.setname("renamed")
    assert m.name == "renamed" and m.get_info()["name"] == "renamed"
    s = port_tm.make_random_matrix("s", [2, 3], [2, 3], occupation=1.0, matrix_type="S",
                                   rng=rng, device="cpu")
    blocks = s.get_blocks([1, 0], [0, 1])
    np.testing.assert_array_equal(blocks[0], blocks[1].T)
    assert s.get_blocks([1], [0], unfold=False)[0].shape == (2, 3)


def test_chain_scope_frees_only_what_the_split_adopted():
    with mempool.chain() as ch:
        kept = BlockSparseMatrix("kept", [2], [2], device="cpu")
        kept.put_block(0, 0, np.ones((2, 2)))
        kept.finalize()
        with ch.scope():
            tmp = BlockSparseMatrix("tmp", [2], [2], device="cpu")
            tmp.put_block(0, 0, np.ones((2, 2)))
            tmp.finalize()
            out = BlockSparseMatrix("out", [2], [2], device="cpu")
            ch.detach(out)
        assert tmp.nblks == 0 and not tmp.valid
        assert kept.nblks == 1 and kept.valid
        ch.detach(kept)
    assert kept.nblks == 1 and out.valid


def test_timings_registry_and_hooks(tmp_path):
    timings.reset()
    with timings.timed("outer"):
        with timings.timed("inner"):
            pass
    outer, inner = timings._stats["outer"], timings._stats["inner"]
    assert outer.calls == inner.calls == 1
    assert outer.total >= inner.total and outer.self_time <= outer.total
    assert outer.callees["inner"][0] == 1
    lines = []
    timings.report(out=lines.append)
    assert any("outer" in ln for ln in lines) and any("SELF" in ln for ln in lines)
    path = tmp_path / "callgraph.out"
    timings.export_callgraph(str(path))
    text = path.read_text()
    assert "events:" in text and "cfn=inner" in text
    calls = []
    timings.set_hooks(lambda n: calls.append(("set", n)), lambda n: calls.append(("stop", n)))
    try:
        with timings.timed("hooked"):
            pass
    finally:
        timings.set_hooks(None, None)
    assert calls == [("set", "hooked"), ("stop", "hooked")]
    assert "hooked" not in timings._stats
    timings.timeset("a")
    with pytest.raises(RuntimeError, match="mismatch"):
        timings.timestop("b")
    timings.reset()


def test_contract_is_timed():
    _, pa = _rand("a", [[2, 2], [3]], occ=1.0, seed=28)
    _, pb = _rand("b", [[3], [2]], occ=1.0, seed=29)
    _, pc = _empty("c", [[2, 2], [2]])
    timings.reset()
    contract(1.0, pa, pb, 0.0, pc, (1,), (0,), (0,), (1,))
    assert timings._stats["tensor_contract"].calls == 1
    assert timings._stats["tensor_contract"].callees["tas_multiply"][0] == 1
