"""Tensor contraction: the counterpart of `dbcsr_tpu/tensor/contract.py`.

Ref `dbcsr_t_contract` (`dbcsr_tensor.F:418`) and its expert path
(:540): align indices (:1162), remap operands to matrix-compatible
layouts (`reshape_mm_compatible`, :1183), run the TAS multiply, map the
result back.  `contract_a[i]` is contracted against `contract_b[i]`;
`notcontract_a` dims land in C at positions `map_1` (order-preserving),
`notcontract_b` at `map_2`.

Each contraction is one product on the ops plane, as in the JAX package
(`dbcsr_tpu/tensor/contract.py:255-270`): an event-bus product scope
``tensor_contract`` (a flight record and a product id under which the
inner multiplies nest) and the tracer span's attributes.  Inside the
``tensor_contract`` region, the operands' restriction, their remaps and
the copy of the result into C's mapping are `core.timings` regions of
their own (``tensor_restrict``, ``tensor_remap``, ``tensor_copy``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dbcsr_tpu_torch.core import mempool
from dbcsr_tpu_torch.core.matrix import to_index
from dbcsr_tpu_torch.core.timings import timed
from dbcsr_tpu_torch.obs import events, tracer
from dbcsr_tpu_torch.ops.operations import compress, copy as matrix_copy, scale
from dbcsr_tpu_torch.tas.mm import tas_multiply
from dbcsr_tpu_torch.tensor.types import BlockSparseTensor


def _remap_rows(bin_data: torch.Tensor, slots: torch.Tensor, src_shape, comb,
                dst_shape) -> torch.Tensor:
    """Gather, per-block nd transpose and reshape, on the device: the
    block movement of the reshape path (ref the buffered block alltoall
    in `dbcsr_tensor_reshape.F:288`; the JAX package's jitted
    `_remap_rows`).  `index_select` + `permute` + `reshape`, a new
    tensor: the source's bins are not written."""
    n = slots.shape[0]
    x = bin_data.index_select(0, slots).reshape((n,) + tuple(src_shape))
    y = x.permute((0,) + tuple(1 + i for i in comb))
    return y.reshape((n,) + tuple(dst_shape))


def _flat_multi(nd_idx: np.ndarray, dims: Sequence[int], nblks) -> np.ndarray:
    """Vectorized mixed-radix linearization (C-order over `dims`)."""
    f = np.zeros(len(nd_idx), np.int64)
    for d in dims:
        f = f * nblks[d] + nd_idx[:, d]
    return f


def remap(
    t: BlockSparseTensor,
    row_dims: Sequence[int],
    col_dims: Sequence[int],
    name: Optional[str] = None,
) -> BlockSparseTensor:
    """Same tensor, different nd->2d mapping (ref `dbcsr_t_remap`,
    `dbcsr_tensor.F:1604`).

    Fully device-side: blocks are grouped by nd shape, gathered,
    permuted and re-laid-out once per shape group, then
    staged into the output matrix without any host round-trip of block
    data (the reference moves blocks with a buffered MPI alltoall,
    `dbcsr_tensor_reshape.F:67,288`; the single-controller analog is
    device gather/scatter)."""
    row_dims, col_dims = tuple(row_dims), tuple(col_dims)
    if (row_dims, col_dims) == (t.row_dims, t.col_dims):
        return t
    t.finalize()
    out = BlockSparseTensor(
        name or t.name, t.blk_sizes, row_dims, col_dims, t.dtype, t.device
    )
    mat = t.matrix
    n = mat.nblks
    if n == 0:
        return out.finalize()
    nd_idx = t.entry_multi_coords()
    nblks = t.nblks_per_dim
    shp = np.empty((n, t.ndim), np.int64)
    for d in range(t.ndim):
        shp[:, d] = t.blk_sizes[d][nd_idx[:, d]]
    _, ginv = np.unique(shp, axis=0, return_inverse=True)
    old_perm = t.row_dims + t.col_dims
    new_perm = row_dims + col_dims
    comb = tuple(old_perm.index(d) for d in new_perm)
    new_rows = _flat_multi(nd_idx, row_dims, nblks)
    new_cols = _flat_multi(nd_idx, col_dims, nblks)
    for g in range(ginv.max() + 1):
        sel = np.nonzero(ginv == g)[0]
        s = shp[sel[0]]
        # one nd shape + one mapping -> one matrix shape -> one source bin
        bid = mat.ent_bin[sel[0]]
        src_shape = tuple(int(s[d]) for d in old_perm)
        dst_shape = (
            int(np.prod([s[d] for d in row_dims], dtype=np.int64)),
            int(np.prod([s[d] for d in col_dims], dtype=np.int64)),
        )
        moved = _remap_rows(mat.bins[bid].data, to_index(mat.ent_slot[sel], t.device),
                            src_shape, comb, dst_shape)
        out.matrix.stage_device_blocks(new_rows[sel], new_cols[sel], moved)
    return out.finalize()


def tensor_copy(
    dest: BlockSparseTensor, src: BlockSparseTensor, summation: bool = False
) -> BlockSparseTensor:
    """Copy blocks between same-shape tensors in any mappings
    (ref `dbcsr_t_copy` -> `dbcsr_t_reshape`, `dbcsr_tensor_reshape.F:67`).

    Device-side: src is remapped into dest's mapping (one fused
    gather/permute per shape group), then its bins are staged into
    dest's matrix and merged by the batched finalize — no host
    round-trip of block data."""
    if dest.nblks_per_dim != src.nblks_per_dim:
        raise ValueError("tensor shapes differ")
    for d in range(src.ndim):
        # per-dim block sizes must match, not just counts: different
        # blockings can flatten to identical matrix block shapes and
        # would otherwise copy with silently reinterpreted data
        if not np.array_equal(dest.blk_sizes[d], src.blk_sizes[d]):
            raise ValueError(f"tensor dim {d} blockings differ")
    src2 = remap(src, dest.row_dims, dest.col_dims)
    src2.finalize()
    mat = src2.matrix
    nbc = mat.nblkcols
    for b_id, b in enumerate(mat.bins):
        if b.count == 0:
            continue
        sel = np.nonzero(mat.ent_bin == b_id)[0]
        keys_by_slot = np.empty(b.count, np.int64)
        keys_by_slot[mat.ent_slot[sel]] = mat.keys[sel]
        dest.matrix.stage_device_blocks(
            keys_by_slot // nbc, keys_by_slot % nbc,
            b.data[: b.count], summation=summation,
        )
    return dest.finalize()


def restrict_tensor(
    t: BlockSparseTensor,
    dim_bounds,
    name: Optional[str] = None,
) -> BlockSparseTensor:
    """Restrict to blocks whose multi-index lies within ``dim_bounds``
    — a {dim: (lo, hi)} map of inclusive block-index ranges (the
    restriction step behind the reference's contract ``bounds_1/2/3``
    arguments, `dbcsr_tensor.F:470-490`).

    When no restriction applies (and no ``name`` is requested), the
    input tensor itself is returned — callers must not mutate the
    result in place.  With a ``name`` or an effective restriction, a
    fresh copy is returned."""
    dim_bounds = {d: b for d, b in (dim_bounds or {}).items() if b is not None}
    mask = None
    if dim_bounds:
        nd_idx = t.entry_multi_coords()
        mask = np.ones(len(nd_idx), bool)
        for d, (lo, hi) in dim_bounds.items():
            mask &= (nd_idx[:, d] >= lo) & (nd_idx[:, d] <= hi)
        if mask.all():
            mask = None
    if mask is None:
        if name is None:
            # no restriction: share the tensor (downstream remap /
            # multiply do not mutate their inputs, so the O(nnz) copy
            # is pure overhead on every bound-less contract)
            return t
        out = BlockSparseTensor(name, t.blk_sizes, t.row_dims, t.col_dims, t.dtype,
                                t.device)
        out.matrix = matrix_copy(t.matrix, name=name)
        return out
    out = BlockSparseTensor(
        name or t.name, t.blk_sizes, t.row_dims, t.col_dims, t.dtype, t.device
    )
    out.matrix = compress(matrix_copy(t.matrix, name=out.name), mask)
    return out


def contract(
    alpha,
    tensor_a: BlockSparseTensor,
    tensor_b: BlockSparseTensor,
    beta,
    tensor_c: BlockSparseTensor,
    contract_a: Sequence[int],
    notcontract_a: Sequence[int],
    contract_b: Sequence[int],
    notcontract_b: Sequence[int],
    map_1: Optional[Sequence[int]] = None,
    map_2: Optional[Sequence[int]] = None,
    filter_eps: Optional[float] = None,
    nsplit: Optional[int] = None,
    bounds_1=None,
    bounds_2=None,
    bounds_3=None,
    mesh=None,
) -> int:
    """C[map_1, map_2] = alpha * sum over contracted dims of A*B + beta*C.

    Returns flops.  (ref `dbcsr_t_contract`, `dbcsr_tensor.F:418`)

    ``bounds_1[i]`` optionally restricts contracted dim pair
    (contract_a[i], contract_b[i]) to an inclusive block-index range;
    ``bounds_2[i]`` restricts notcontract_a[i], ``bounds_3[i]``
    notcontract_b[i] (ref bounds args, `dbcsr_tensor.F:470-490`; the
    batched-contraction driver chunks index space with these).
    ``mesh`` (a `parallel.mesh.Grid`) runs the TAS multiply on the grid
    engines.
    """
    ca, nca = tuple(contract_a), tuple(notcontract_a)
    cb, ncb = tuple(contract_b), tuple(notcontract_b)
    if map_1 is None:
        map_1 = tuple(range(len(nca)))
    if map_2 is None:
        map_2 = tuple(range(len(nca), len(nca) + len(ncb)))
    map_1, map_2 = tuple(map_1), tuple(map_2)

    if sorted(ca + nca) != list(range(tensor_a.ndim)):
        raise ValueError("contract_a + notcontract_a must partition A dims")
    if sorted(cb + ncb) != list(range(tensor_b.ndim)):
        raise ValueError("contract_b + notcontract_b must partition B dims")
    if len(ca) != len(cb):
        raise ValueError("contracted dim counts differ")
    for da, db in zip(ca, cb):
        if not np.array_equal(tensor_a.blk_sizes[da], tensor_b.blk_sizes[db]):
            raise ValueError(f"contracted dim blockings differ: A{da} vs B{db}")
    if sorted(map_1 + map_2) != list(range(tensor_c.ndim)):
        raise ValueError("map_1 + map_2 must partition C dims")
    for da, dc in zip(nca, map_1):
        if not np.array_equal(tensor_a.blk_sizes[da], tensor_c.blk_sizes[dc]):
            raise ValueError(f"A dim {da} blocking != C dim {dc}")
    for db, dc in zip(ncb, map_2):
        if not np.array_equal(tensor_b.blk_sizes[db], tensor_c.blk_sizes[dc]):
            raise ValueError(f"B dim {db} blocking != C dim {dc}")

    def _bounds_map(dims, bounds):
        if bounds is None:
            return {}
        bounds = list(bounds)
        if len(bounds) != len(dims):
            raise ValueError("bounds length must match the dim-section length")
        return {d: b for d, b in zip(dims, bounds) if b is not None}

    a_bounds = {**_bounds_map(ca, bounds_1), **_bounds_map(nca, bounds_2)}
    b_bounds = {**_bounds_map(cb, bounds_1), **_bounds_map(ncb, bounds_3)}

    # batched-contraction state on C defers filtering to the finalize;
    # the split decision is cached by the TAS batched-MM state that
    # batched_contract_init installed on C's matrix
    # (ref dbcsr_t_batched_contract_init/finalize, dbcsr_tensor.F:1964-2186)
    batch = getattr(tensor_c, "_batched_state", None)
    if batch is not None:
        if filter_eps is not None:
            batch["filter_eps"] = filter_eps
        filter_eps = None

    with timed("tensor_contract"), events.product_scope(
            "tensor_contract", tensor_c.name, a=tensor_a.name, b=tensor_b.name,
            ndim_a=tensor_a.ndim, ndim_b=tensor_b.ndim):
        tracer.annotate(
            a=tensor_a.name, b=tensor_b.name, c=tensor_c.name,
            contract_a=list(ca), contract_b=list(cb),
            ndim_a=tensor_a.ndim, ndim_b=tensor_b.ndim,
            bounded=bool(a_bounds or b_bounds),
        )
        # device-resident contraction intermediates (core.mempool): the
        # restriction copies, the remapped operand layouts and the
        # result-layout shell are all chain-owned, freed the moment
        # they are dead, so their blocks return to the caching allocator
        # for the next step.  The caller's tensors were created outside
        # this chain and are never adopted or freed by it.
        with mempool.chain() as ch:
            with timed("tensor_restrict"):
                restricted_a = restrict_tensor(tensor_a, a_bounds)
                restricted_b = restrict_tensor(tensor_b, b_bounds)
            # remap operands into matrix-compatible layouts (ref :1183)
            with timed("tensor_remap"):
                a2 = remap(restricted_a, nca, ca, name=tensor_a.name + "_mm")
                b2 = remap(restricted_b, cb, ncb, name=tensor_b.name + "_mm")
            # restrict/remap may have passed an operand through
            # unchanged; if the caller aliased C to an operand,
            # multiply would then read A/B while overwriting them —
            # copy to break the alias
            if a2.matrix is tensor_c.matrix:
                a2.matrix = matrix_copy(a2.matrix, name=a2.name)
            if b2.matrix is tensor_c.matrix:
                b2.matrix = matrix_copy(b2.matrix, name=b2.name)
            c_layout = (map_1, map_2)
            if (tensor_c.row_dims, tensor_c.col_dims) == c_layout:
                flops = tas_multiply(
                    "N", "N", alpha, a2.matrix, b2.matrix, beta,
                    tensor_c.matrix,
                    filter_eps=filter_eps, nsplit=nsplit, mesh=mesh,
                )
                return flops
            tmp = BlockSparseTensor(
                tensor_c.name + "_mm", tensor_c.blk_sizes, map_1, map_2,
                tensor_c.dtype, tensor_c.device
            )
            tmp.finalize()
            flops = tas_multiply(
                "N", "N", alpha, a2.matrix, b2.matrix, 0.0, tmp.matrix,
                filter_eps=filter_eps, nsplit=nsplit, mesh=mesh,
            )
            # the remapped operands are dead once the multiply returned:
            # free them before the result is copied into C's mapping
            ch.retire(a2.matrix)
            ch.retire(b2.matrix)
            if beta != 1.0:
                scale(tensor_c.matrix, beta)
            with timed("tensor_copy"):
                tensor_copy(tensor_c, tmp, summation=True)
            return flops


def contract_test(
    alpha,
    tensor_a: BlockSparseTensor,
    tensor_b: BlockSparseTensor,
    beta,
    tensor_c: BlockSparseTensor,
    contract_a: Sequence[int],
    notcontract_a: Sequence[int],
    contract_b: Sequence[int],
    notcontract_b: Sequence[int],
    map_1: Optional[Sequence[int]] = None,
    map_2: Optional[Sequence[int]] = None,
    eps: Optional[float] = None,
    io=print,
    **contract_kwargs,
) -> bool:
    """Run the contraction AND verify it against a dense einsum oracle
    (ref `dbcsr_t_contract_test`, `dbcsr_tensor_api.F:55`): returns
    True when the result matches within ``eps`` (dtype-scaled default),
    False otherwise, reporting the error through ``io``.  ``tensor_c``
    is updated with the contraction result either way."""
    ca, nca = tuple(contract_a), tuple(notcontract_a)
    cb, ncb = tuple(contract_b), tuple(notcontract_b)
    if map_1 is None:
        map_1 = tuple(range(len(nca)))
    if map_2 is None:
        map_2 = tuple(range(len(nca), len(nca) + len(ncb)))
    if contract_kwargs.get("filter_eps") is not None:
        raise ValueError(
            "contract_test's dense oracle cannot model filter_eps; "
            "call contract() directly for filtered contractions"
        )
    dense_a = tensor_a.to_dense().copy()
    dense_b = tensor_b.to_dense().copy()
    dense_c0 = tensor_c.to_dense()

    # bounds semantics (same as contract): operands are zeroed outside
    # the block-index windows, so the oracle masks its dense inputs
    def _mask(dense, tensor, dim, lo_hi):
        off = np.concatenate([[0], np.cumsum(tensor.blk_sizes[dim])])
        lo, hi = lo_hi
        sl = [slice(None)] * dense.ndim
        sl[dim] = slice(0, int(off[lo]))
        dense[tuple(sl)] = 0
        sl[dim] = slice(int(off[hi + 1]), None)
        dense[tuple(sl)] = 0

    for i, b in enumerate(contract_kwargs.get("bounds_1") or []):
        if b is not None:
            _mask(dense_a, tensor_a, ca[i], b)
            _mask(dense_b, tensor_b, cb[i], b)
    for i, b in enumerate(contract_kwargs.get("bounds_2") or []):
        if b is not None:
            _mask(dense_a, tensor_a, nca[i], b)
    for i, b in enumerate(contract_kwargs.get("bounds_3") or []):
        if b is not None:
            _mask(dense_b, tensor_b, ncb[i], b)
    # einsum subscripts: one letter per A dim; contracted B dims share
    # A's letters, free B dims get fresh ones; C positions by map_1/2
    letters = iter("abcdefghijklmnopqrstuvwxyz")
    sub_a = [next(letters) for _ in range(tensor_a.ndim)]
    sub_b = [None] * tensor_b.ndim
    for da, db in zip(ca, cb):
        sub_b[db] = sub_a[da]
    for db in ncb:
        sub_b[db] = next(letters)
    sub_c = [None] * tensor_c.ndim
    for da, dc in zip(nca, map_1):
        sub_c[dc] = sub_a[da]
    for db, dc in zip(ncb, map_2):
        sub_c[dc] = sub_b[db]
    spec = f"{''.join(sub_a)},{''.join(sub_b)}->{''.join(sub_c)}"
    want = alpha * np.einsum(spec, dense_a, dense_b) + beta * dense_c0

    contract(alpha, tensor_a, tensor_b, beta, tensor_c,
             ca, nca, cb, ncb, map_1=map_1, map_2=map_2, **contract_kwargs)
    got = tensor_c.to_dense()
    if eps is None:
        resolution = float(torch.finfo(tensor_c.dtype).resolution)
        k_extent = int(np.prod(
            [int(tensor_a.blk_sizes[d].sum()) for d in ca], dtype=np.int64
        ))
        eps = 100.0 * np.sqrt(max(k_extent, 1)) * resolution
    scale_ref = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max()) / scale_ref
    ok = bool(np.isfinite(err) and err <= eps)
    io(f" contract_test {spec}: max rel err {err:.3e} "
       f"{'<=' if ok else '>'} eps {eps:.1e} -> {'OK' if ok else 'FAILED'}")
    return ok
