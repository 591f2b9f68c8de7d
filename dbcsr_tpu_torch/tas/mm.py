"""TAS multiply: CARMA-style split of the long dimension.

Counterpart of `dbcsr_tpu/tas/mm.py` (ref `dbcsr_tas_multiply`,
`dbcsr_tas_mm.F:79`): pick the long dimension of C = op(A) op(B); split
it into nsplit groups; run an ordinary multiply per group.  The
reference replicates the small matrix into each process group and
redistributes and sums afterwards (`redistribute_and_sum`, :783); on one
device the group loop reuses the engine's block-index limits, which
bound each group's working set while keeping a fixed, deterministic
accumulation order.  An unfiltered split first builds C's final pattern
once, beta applied (`mm.multiply.prebuild_c`, region
``tas_c_prebuild``), so each group's multiply finds every key it writes
in C and accumulates into C's bins where they are; the JAX package
restructures C in every group instead.

With ``mesh=`` (a `parallel.mesh.Grid`) the split runs on the grid, as
the JAX package's per-group Cannons do (`_tas_multiply_mesh`).  The
tracer span carries the JAX package's attributes: name, m, n, k, the
long dimension and nsplit (`dbcsr_tpu/tas/mm.py:95`, `:164`).
"""

from __future__ import annotations

from typing import Optional, Union

from dbcsr_tpu_torch.core import mempool
from dbcsr_tpu_torch.core.config import get_config
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.core.timings import timed
from dbcsr_tpu_torch.mm.multiply import multiply, prebuild_c
from dbcsr_tpu_torch.obs import tracer
from dbcsr_tpu_torch.ops.operations import scale
from dbcsr_tpu_torch.parallel.mesh import Grid, optimize_grid
from dbcsr_tpu_torch.tas.base import TASMatrix
from dbcsr_tpu_torch.tas.split import (
    choose_nsplit,
    choose_nsplit_traffic,
    estimate_split_factor,
)

# ref default_nsplit_accept_ratio (`dbcsr_tas_split.F:57`): a cached
# batch split survives while within this factor of the current optimum
_NSPLIT_ACCEPT_RATIO = 3.0


def _unwrap(x: Union[TASMatrix, BlockSparseMatrix]) -> BlockSparseMatrix:
    return x.matrix if isinstance(x, TASMatrix) else x


def tas_multiply(
    transa: str,
    transb: str,
    alpha,
    matrix_a: Union[TASMatrix, BlockSparseMatrix],
    matrix_b: Union[TASMatrix, BlockSparseMatrix],
    beta,
    matrix_c: Union[TASMatrix, BlockSparseMatrix],
    filter_eps: Optional[float] = None,
    nsplit: Optional[int] = None,
    ngroups_max: int = 64,
    mesh=None,
) -> int:
    """C = alpha op(A) op(B) + beta C with long-dimension splitting.

    Returns total flops.  ``nsplit=None`` chooses the split from the
    split-factor estimate (ref `dbcsr_tas_mm.F:1427`) times
    ``tas_split_factor``; ``nsplit=1`` is a single multiply.  The split
    taken is left in ``c._tas_nsplit``.  With ``mesh`` (a
    `parallel.mesh.Grid`) the groups run on the grid engines, and on a
    square grid the split minimizes the modeled panel traffic
    (`choose_nsplit_traffic`)."""
    if mesh is not None and not isinstance(mesh, Grid):
        raise TypeError(f"mesh must be a dbcsr_tpu_torch.parallel Grid, got "
                        f"{type(mesh).__name__}")
    a = _unwrap(matrix_a)
    b = _unwrap(matrix_b)
    c = _unwrap(matrix_c)
    for m in (a, b, c):
        if not m.valid:
            m.finalize()
    # op() shapes
    m_full = c.nfullrows
    n_full = c.nfullcols
    k_full = a.nfullcols if transa.upper() == "N" else a.nfullrows
    nblk_k = a.nblkcols if transa.upper() == "N" else a.nblkrows

    # batched-MM state machine (ref dbcsr_tas_mm.F:1595-1692): defer
    # filtering to the batch finalize, reuse the split decision
    explicit_nsplit = nsplit is not None
    batch = getattr(c, "_tas_batched_state", None)
    if batch is not None:
        if filter_eps is not None:
            batch["filter_eps"] = filter_eps
        filter_eps = None
        if not explicit_nsplit:
            nsplit = batch.get("nsplit")

    with timed("tas_multiply"):
        dims = {"m": m_full, "n": n_full, "k": k_full}
        long_dim = max(dims, key=dims.get)
        tracer.annotate(name=c.name, m=m_full, n=n_full, k=k_full, long_dim=long_dim)

        def _fresh_opt() -> int:
            long_blks = max(c.nblkrows, c.nblkcols, nblk_k)
            if mesh is not None and mesh.shape["pr"] == mesh.shape["pc"]:
                # the split that minimizes the modeled panel traffic (the
                # role of the reference's split-factor/pgrid acceptance,
                # `dbcsr_tas_mm.F:1427-1464`); rectangular grids cannot
                # group, so there the geometric estimate stays
                g = choose_nsplit_traffic(
                    long_dim, m_full, n_full, k_full, a.nnz, b.nnz, c.nnz,
                    c.dtype.itemsize,
                    mesh.shape["kl"], mesh.shape["pr"], ngroups_max, long_blks)
                if g is not None:
                    return g
            sf = estimate_split_factor(
                m_full, n_full, k_full, a.nnz, b.nnz, c.nnz
            ) * get_config().tas_split_factor  # ref TAS_SPLIT_FACTOR knob
            return choose_nsplit(sf, ngroups_max, long_blks)

        if nsplit is None:
            for t in (matrix_a, matrix_b, matrix_c):
                if isinstance(t, TASMatrix) and t.nsplit:
                    nsplit = t.nsplit
                    break
        if nsplit is None:
            nsplit = _fresh_opt()
        if batch is not None:
            if explicit_nsplit or batch.get("nsplit") is None:
                batch["nsplit"] = nsplit  # (re)set the batch's split
                if explicit_nsplit:
                    batch["nsplit_explicit"] = True
            elif not batch.get("nsplit_explicit"):
                # split re-optimization between batches (the analog of the
                # batched pgrid re-optimization, `dbcsr_tensor.F:1964-2186`):
                # keep the cached split while it stays within the
                # reference's acceptance window of the current optimum
                # (`dbcsr_tas_split.F:57,229-230`), else re-split.  nnz
                # reads are O(nblks) host work, so the optimum is recomputed
                # only when the block-count triple drifted beyond the
                # acceptance ratio since it was last checked
                ratio = _NSPLIT_ACCEPT_RATIO
                cnt_now = (a.nblks, b.nblks, c.nblks)
                cnt_ref = batch.get("nblks_checked")
                drifted = cnt_ref is None or any(
                    now > ratio * max(ref, 1) or now * ratio < ref
                    for now, ref in zip(cnt_now, cnt_ref))
                if drifted:
                    batch["nblks_checked"] = cnt_now
                    opt = _fresh_opt()
                    if not (opt / ratio <= nsplit <= opt * ratio):
                        batch["nsplit"] = nsplit = opt
                        batch["resplit_count"] = batch.get("resplit_count", 0) + 1

        c._tas_nsplit = int(max(nsplit, 1))
        tracer.annotate(nsplit=int(nsplit or 1))
        if mesh is not None:
            if batch is not None:
                # batched pgrid re-optimization (ref `dbcsr_tensor.F:1964-2186`):
                # re-factor the same images to the batch's split, cached in
                # the batch state and re-evaluated when the split changes
                key = (id(mesh), max(nsplit, 1), long_dim)
                if batch.get("pgrid_key") != key:
                    batch["pgrid_key"] = key
                    batch["pgrid_src"] = mesh  # keeps id(mesh) unique
                    batch["pgrid"] = optimize_grid(mesh, max(nsplit, 1), long_dim)
                    if batch["pgrid"] is not mesh:
                        batch["repgrid_count"] = batch.get("repgrid_count", 0) + 1
                mesh = batch["pgrid"]
            return _tas_multiply_mesh(transa, transb, alpha, a, b, beta, c, filter_eps,
                                      max(nsplit, 1), long_dim, mesh)
        if nsplit <= 1:
            return multiply(transa, transb, alpha, a, b, beta, c, filter_eps=filter_eps)

        # beta applies once to all of C, then groups accumulate.  Limits
        # take the stack format (`format_planner.choose`), so unfiltered
        # groups add exactly C's final keys: built once here, C's bins
        # stay in place through the loop.  A filtered product's survivors
        # are known only group by group; an operand aliased to C would be
        # restructured under the groups that read it.
        if filter_eps is None and a is not c and b is not c:
            with timed("tas_c_prebuild"):
                prebuild_c(transa, transb, a, b, beta, c)
        elif beta != 1.0:
            scale(c, beta)
        flops = 0
        if long_dim == "m":
            nblk, limit_lo, limit_hi = c.nblkrows, "first_row", "last_row"
        elif long_dim == "n":
            nblk, limit_lo, limit_hi = c.nblkcols, "first_col", "last_col"
        else:
            nblk, limit_lo, limit_hi = nblk_k, "first_k", "last_k"
        per = -(-nblk // nsplit)
        # the split loop is a chained workload (core.mempool): each
        # group's multiply runs in a chain scope, so engine temporaries
        # (op() transposes, desymmetrized copies) return to the allocator
        # as soon as the group is done.  C itself is the caller's
        # (created outside the chain): never adopted, never freed here.
        with mempool.chain() as ch:
            for g0 in range(0, nblk, per):
                g1 = min(g0 + per, nblk)
                with ch.scope():
                    flops += multiply(transa, transb, alpha, a, b, 1.0, c,
                                      filter_eps=filter_eps,
                                      **{limit_lo: g0, limit_hi: g1 - 1})
        return flops



def _tas_multiply_mesh(transa, transb, alpha, a, b, beta, c, filter_eps, nsplit, long_dim,
                       mesh) -> int:
    """The TAS multiply on a grid.  m- or n-long products run
    `tas_grouped_multiply`: nsplit per-group Cannons over the 'kl' axis
    with the short matrix replicated into each group (ref
    `dbcsr_tas_mm.F:79-806`, `dbcsr_tas_split.F:304`); a column-long C
    runs as C^T with row groups.  k-long products, and every product on
    a rectangular or one-layer grid, run the layered sparse Cannon
    (`sparse_multiply_distributed`), the same grid split applied to the
    contraction dimension (`dbcsr_mm_3d.F:1037`).  The result's
    structure is adopted into ``c``."""
    from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY, _Bin
    from dbcsr_tpu_torch.ops.transformations import new_transposed
    from dbcsr_tpu_torch.parallel.sparse_dist import (
        sparse_multiply_distributed,
        tas_grouped_multiply,
    )

    def _op(m, trans):
        t = trans.upper()
        if t == "N":
            return m
        return new_transposed(m, conjugate=t == "C" and m.dtype.is_complex)

    a_op, b_op = _op(a, transa), _op(b, transb)
    grouped = (nsplit > 1 and mesh.shape["kl"] > 1 and mesh.shape["pr"] == mesh.shape["pc"]
               and long_dim in ("m", "n"))
    if grouped and long_dim == "m":
        acc = tas_grouped_multiply(alpha, a_op, b_op, beta, c, mesh, name=c.name,
                                   filter_eps=filter_eps, nsplit=nsplit)
    elif grouped:
        # column-long C: C^T = op(B)^T op(A)^T is row-long
        acc_t = tas_grouped_multiply(alpha, new_transposed(b_op), new_transposed(a_op), beta,
                                     new_transposed(c), mesh, name=c.name + "^T",
                                     filter_eps=filter_eps, nsplit=nsplit)
        acc = new_transposed(acc_t)
        acc._last_flops = acc_t._last_flops
    else:
        acc = sparse_multiply_distributed(alpha, a_op, b_op, beta, c, mesh, name=c.name,
                                          filter_eps=filter_eps)
    # adopt the product's structure into the caller's C (plain: the grid
    # engines desymmetrize); acc is a temporary, so its bins move over
    c.matrix_type = NO_SYMMETRY
    c.set_structure_from_device(acc.keys, [_Bin(b.shape, b.data.to(c.device), b.count)
                                           for b in acc.bins],
                                binning=(acc.ent_bin, acc.ent_slot,
                                         [b.shape for b in acc.bins]))
    return int(acc._last_flops)
