"""Matrix operations.

Counterpart of `dbcsr_tpu/ops/operations.py` (ref
`src/ops/dbcsr_operations.F`): compress and filter, scale and
`scale_by_vector`, the named element functions (`FUNC_*`,
`function_of_elements`), add (pattern union, same-pattern fast path)
and its out-of-place `added`, copy and `copy_into_existing`,
set/clear, the block reserves, `get_block_diag`, `hadamard_product`,
trace, dot, the Frobenius, max-abs and Gershgorin norms,
`column_norms`, diagonal access, `triu`, the element crop the
multiply's limits use, and `verify_matrix`.  Index logic runs on the host with NumPy; block data is
touched in bulk, one batched torch call per shape bin, never block by
block.  `scale`, `set_value`, `set_diag` and `add_on_diag` update bins
in place where the JAX package rebinds a fresh array, which is safe
because no two matrices share a bin tensor (`copy` clones) and a bin a
cache holds is copied first (`BlockSparseMatrix.own_bins`); `add`
writes fresh bins, since its operands may be one matrix.  Every value
funnel journals the keys it changed (`_note_mutation`), as the JAX
package's do.  Complex kinds: scalars, `trace` and `dot` are complex,
norms real.  Reductions
that feed an iterate (the Gershgorin row sums) fetch their per-block
partials and sum them on the host in the JAX package's order, so no
atomic float addition makes a run irreproducible.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.core.kinds import host_dtype
from dbcsr_tpu_torch.core.matrix import (
    HERMITIAN,
    NO_SYMMETRY,
    BlockSparseMatrix,
    _Bin,
    _bin_entries,
    to_host,
    to_index,
    window_mask,
)


def _require_valid(*mats: BlockSparseMatrix) -> None:
    for m in mats:
        if not m.valid:
            raise RuntimeError(f"matrix {m.name!r} needs finalize() first")


def _same_blocking(a: BlockSparseMatrix, b: BlockSparseMatrix) -> None:
    if not (np.array_equal(a.row_blk_sizes, b.row_blk_sizes)
            and np.array_equal(a.col_blk_sizes, b.col_blk_sizes)):
        raise ValueError("matrices have different blockings")


def _scalar(x, dtype: torch.dtype):
    """``x`` rounded to the matrix dtype's host type, as the JAX package
    casts its scalars to the matrix dtype before the elementwise op: a
    float, or a complex for a complex kind."""
    v = np.asarray(x).astype(host_dtype(dtype))
    return complex(v) if v.dtype.kind == "c" else float(v)


# --------------------------------------------------------------- structure
def _subset_bins(matrix: BlockSparseMatrix, keep: np.ndarray):
    """(keys, freshly gathered bins) of the ``keep``-masked entries, one
    device gather per bin (sorted slots keep key order within a bin);
    shared by `compress` and `get_block_diag`."""
    ent_bin = matrix.ent_bin[keep]
    ent_slot = matrix.ent_slot[keep]
    bins = []
    for b_id, b in enumerate(matrix.bins):
        slots = np.sort(ent_slot[ent_bin == b_id]).astype(np.int64)
        if len(slots):
            bins.append(_Bin(b.shape, b.data[to_index(slots, b.data.device)], len(slots)))
    return matrix.keys[keep], bins


def compress(matrix: BlockSparseMatrix, keep: np.ndarray) -> BlockSparseMatrix:
    """Drop the entries where ``keep`` is False, rebuilding the bins."""
    _require_valid(matrix)
    if keep.all():
        return matrix
    matrix.set_structure_from_device(*_subset_bins(matrix, keep))
    return matrix


def get_block_diag(matrix: BlockSparseMatrix, name: Optional[str] = None) -> BlockSparseMatrix:
    """A new matrix of the diagonal blocks of ``matrix`` only (ref
    `dbcsr_get_block_diag`, `dbcsr_operations.F:1158`): one gather of
    the diagonal entries per bin, no copy of the rest."""
    _require_valid(matrix)
    out = BlockSparseMatrix(name or f"diag of {matrix.name}", matrix.row_blk_sizes,
                            matrix.col_blk_sizes, matrix.dtype, matrix.dist,
                            matrix.matrix_type, device=matrix.device)
    rows, cols = matrix.entry_coords()
    out.set_structure_from_device(*_subset_bins(matrix, rows == cols))
    return out


def crop_matrix(matrix: BlockSparseMatrix, row_bounds=None, col_bounds=None,
                name: Optional[str] = None) -> BlockSparseMatrix:
    """Copy restricted to an element range (ref `dbcsr_crop_matrix`,
    `dbcsr_operations.F:1666-1847`).  Bounds are inclusive 0-based
    element index pairs; the blocking is unchanged: blocks outside the
    range are dropped, and blocks straddling a bound keep zeros outside
    it (one masked write per shape bin)."""
    _require_valid(matrix)
    from dbcsr_tpu_torch.ops.transformations import desymmetrize

    src = desymmetrize(matrix) if matrix.matrix_type != NO_SYMMETRY else matrix
    out = src.copy(name or f"crop({matrix.name})")
    r0, r1 = row_bounds if row_bounds is not None else (0, out.nfullrows - 1)
    c0, c1 = col_bounds if col_bounds is not None else (0, out.nfullcols - 1)
    roff, coff = out.row_blk_offsets, out.col_blk_offsets
    rows, cols = out.entry_coords()
    compress(out, (roff[rows + 1] - 1 >= r0) & (roff[rows] <= r1)
             & (coff[cols + 1] - 1 >= c0) & (coff[cols] <= c1))
    rows, cols = out.entry_coords()
    r_lo = np.maximum(r0 - roff[rows], 0)
    r_hi = np.minimum(r1 - roff[rows], out.row_blk_sizes[rows] - 1)
    c_lo = np.maximum(c0 - coff[cols], 0)
    c_hi = np.minimum(c1 - coff[cols], out.col_blk_sizes[cols] - 1)
    partial = ((r_lo > 0) | (r_hi < out.row_blk_sizes[rows] - 1)
               | (c_lo > 0) | (c_hi < out.col_blk_sizes[cols] - 1))
    sel = np.nonzero(partial)[0]
    dev = out.device
    for b_id, b in enumerate(out.bins):
        ss = sel[out.ent_bin[sel] == b_id]
        if not len(ss):
            continue
        slots = to_index(out.ent_slot[ss], dev)
        keep = window_mask(b.shape[0], b.shape[1], *(to_index(x[ss], dev)
                                                      for x in (r_lo, r_hi, c_lo, c_hi)))
        b.data[slots] = torch.where(keep, b.data[slots], torch.zeros((), dtype=b.data.dtype,
                                                                     device=dev))
    return out


def filter_matrix(matrix: BlockSparseMatrix, eps: float) -> BlockSparseMatrix:
    """Drop blocks with Frobenius norm below eps (ref `dbcsr_filter`,
    `dbcsr_operations.F:1887`; criterion ||blk||^2 >= eps^2)."""
    _require_valid(matrix)
    return compress(matrix, matrix.block_norms() ** 2 >= float(eps) ** 2)


# ------------------------------------------------------------------ scaling
def scale(matrix: BlockSparseMatrix, factor) -> BlockSparseMatrix:
    """In-place A <- factor*A (ref `dbcsr_scale`)."""
    _require_valid(matrix)
    f = _scalar(factor, matrix.dtype)
    matrix.own_bins()
    for b in matrix.bins:
        b.data.mul_(f)
    matrix._note_mutation(matrix.keys)
    return matrix


def scale_by_vector(matrix: BlockSparseMatrix, vector, side: str = "right") -> BlockSparseMatrix:
    """A <- A*diag(v) ("right") or diag(v)*A ("left") (ref
    `dbcsr_scale_by_vector`): each bin's segments of ``v``, rounded to
    the matrix dtype, multiply it in place."""
    _require_valid(matrix)
    if matrix.matrix_type != NO_SYMMETRY:
        # A*diag(v) of a symmetric matrix is not symmetric: triangular
        # storage cannot hold the result
        raise ValueError("scale_by_vector requires a non-symmetric matrix; "
                         "desymmetrize() first")
    v = np.asarray(vector)
    rows, cols = matrix.entry_coords()
    if side == "right":
        if len(v) != matrix.nfullcols:
            raise ValueError("vector length != full cols")
        offsets, which, axis = matrix.col_blk_offsets, cols, 2
    elif side == "left":
        if len(v) != matrix.nfullrows:
            raise ValueError("vector length != full rows")
        offsets, which, axis = matrix.row_blk_offsets, rows, 1
    else:
        raise ValueError(side)
    hdt = host_dtype(matrix.dtype)
    matrix.own_bins()
    for b_id, b in enumerate(matrix.bins):
        sel = np.nonzero(matrix.ent_bin == b_id)[0]
        if not len(sel):
            continue
        seg_len = b.shape[axis - 1]
        segs = np.zeros((b.count, seg_len), hdt)
        segs[matrix.ent_slot[sel]] = v[offsets[which[sel]][:, None] + np.arange(seg_len)]
        segs_t = torch.from_numpy(segs).to(matrix.device, matrix.dtype)
        b.data.mul_(segs_t[:, None, :] if side == "right" else segs_t[:, :, None])
    matrix._note_mutation(matrix.keys)  # every stored value scaled
    return matrix


# named element functions (ref dbcsr_func_* constants,
# `dbcsr_operations.F:72-75`, semantics at :821-960)
FUNC_INVERSE = "inverse"                  # 1/(a1*x+a0); aborts on inf
FUNC_INVERSE_SPECIAL = "inverse_special"  # 1/(x+sign(a0,x)); safe for a0>0
FUNC_TANH = "tanh"                        # tanh(a1*x+a0)
FUNC_DTANH = "dtanh"                      # d tanh(a1*x+a0)/dx
FUNC_DDTANH = "ddtanh"                    # d2 tanh(a1*x+a0)/dx2
FUNC_ARTANH = "artanh"                    # artanh(a1*x+a0); |y|<1 required
FUNC_SIN = "sin"                          # sin(a1*x+a0)
FUNC_COS = "cos"                          # cos(a1*x+a0)
FUNC_DSIN = "dsin"                        # a1*cos(a1*x+a0)
FUNC_DDSIN = "ddsin"                      # -a1^2*sin(a1*x+a0)
FUNC_ASIN = "asin"                        # asin(a1*x+a0); |y|<=1 required
FUNC_SPREAD_FROM_ZERO = "spread_from_zero"  # |x|<|a0| -> sign(a0,x)
FUNC_TRUNCATE = "truncate"                  # |x|>|a0| -> sign(a0,x)


def _signed(a0: float, x: torch.Tensor) -> torch.Tensor:
    """Fortran's sign(a0, x): |a0| with the sign of x."""
    return torch.copysign(torch.tensor(a0, dtype=x.dtype, device=x.device), x)


_NAMED_FUNCS = {
    FUNC_INVERSE: lambda x, a0, a1: 1.0 / (a1 * x + a0),
    FUNC_INVERSE_SPECIAL: lambda x, a0, a1: 1.0 / (x + _signed(a0, x)),
    FUNC_TANH: lambda x, a0, a1: torch.tanh(a1 * x + a0),
    FUNC_DTANH: lambda x, a0, a1: a1 * (1.0 - torch.tanh(a1 * x + a0) ** 2),
    FUNC_DDTANH: lambda x, a0, a1: 2.0 * a1 ** 2 * (torch.tanh(a1 * x + a0) ** 3
                                                    - torch.tanh(a1 * x + a0)),
    FUNC_ARTANH: lambda x, a0, a1: torch.atanh(a1 * x + a0),
    FUNC_SIN: lambda x, a0, a1: torch.sin(a1 * x + a0),
    FUNC_COS: lambda x, a0, a1: torch.cos(a1 * x + a0),
    FUNC_DSIN: lambda x, a0, a1: a1 * torch.cos(a1 * x + a0),
    FUNC_DDSIN: lambda x, a0, a1: -(a1 ** 2) * torch.sin(a1 * x + a0),
    FUNC_ASIN: lambda x, a0, a1: torch.asin(a1 * x + a0),
    FUNC_SPREAD_FROM_ZERO: lambda x, a0, a1: torch.where(x.abs() < abs(a0), _signed(a0, x), x),
    FUNC_TRUNCATE: lambda x, a0, a1: torch.where(x.abs() > abs(a0), _signed(a0, x), x),
}

# domain guards the reference enforces with DBCSR_ABORT after MAXVAL
# (`dbcsr_operations.F:926,941,956`): (on y = a1*x+a0 "pre" or on the
# result "post", the test, the message)
_FUNC_DOMAIN = {
    FUNC_INVERSE: ("post", lambda y: ~torch.isfinite(y), "division by zero"),
    FUNC_ARTANH: ("pre", lambda y: y.abs() >= 1.0, "ARTANH undefined for |x|>=1"),
    FUNC_ASIN: ("pre", lambda y: y.abs() > 1.0, "ASIN undefined for |x|>1"),
}


def function_of_elements(matrix: BlockSparseMatrix, fn, *args, a0: float = 0.0,
                         a1: float = 1.0, a2: float = 0.0) -> BlockSparseMatrix:
    """Apply an elementwise function to the stored blocks only (ref
    `dbcsr_function_of_elements`, `dbcsr_operations.F:821`).  ``fn`` is
    a ``FUNC_*`` name, with the reference's (a0, a1, a2) parameters
    positional or by keyword and its domain aborts (`FloatingPointError`,
    raised before any block changes), or any callable taking a bin's
    tensor (extra positional args pass through to it).  A bin holds no
    rows beyond its count, so ``fn(0) != 0`` touches no padding."""
    _require_valid(matrix)
    if callable(fn):
        matrix.map_bin_data(lambda d: fn(d, *args).to(d.dtype))
        return matrix
    if args:
        if len(args) > 3:
            raise TypeError("at most (a0, a1, a2) positional parameters")
        a0, a1, a2 = (list(args) + [a0, a1, a2][len(args):])[:3]
    if fn not in _NAMED_FUNCS:
        raise ValueError(f"unknown function of matrix elements: {fn!r}")
    if matrix.dtype.is_complex:
        # ref: "Operation is implemented only for dp real values"
        raise TypeError("named element functions require a real matrix")
    f = _NAMED_FUNCS[fn]
    guard = _FUNC_DOMAIN.get(fn)
    if guard is not None:
        when, pred, msg = guard
        for b in matrix.bins:
            if b.count:
                probe = (a1 * b.data + a0) if when == "pre" else f(b.data, a0, a1)
                if bool(pred(probe).any()):
                    raise FloatingPointError(msg)
    matrix.map_bin_data(lambda d: f(d, a0, a1).to(d.dtype))
    return matrix


# ---------------------------------------------------------------- additive
def _add_aligned(a: BlockSparseMatrix, b: BlockSparseMatrix) -> bool:
    """True when a and b share pattern, dtype and bin geometry, so `add`
    reduces to one elementwise axpby per bin (the same values as the
    union path: A's term first)."""
    if a.nblks == 0 or a.nblks != b.nblks or a.dtype != b.dtype:
        return False
    if len(a.bins) != len(b.bins) or not np.array_equal(a.keys, b.keys):
        return False
    if any(ba.shape != bb.shape or ba.count != bb.count
           for ba, bb in zip(a.bins, b.bins)):
        return False
    return bool(np.array_equal(a.ent_bin, b.ent_bin)
                and np.array_equal(a.ent_slot, b.ent_slot))


def _add_checks(matrix_a, matrix_b) -> None:
    _require_valid(matrix_a, matrix_b)
    _same_blocking(matrix_a, matrix_b)
    if matrix_a.matrix_type != matrix_b.matrix_type:
        # as the JAX package: callers desymmetrize the stricter side first
        raise ValueError("mixed symmetry add not supported")
    if matrix_a.dtype != matrix_b.dtype:
        raise TypeError(f"dtypes differ: {matrix_a.dtype}/{matrix_b.dtype}")


def _axpby(da, db, alpha: float, beta: float):
    return da * alpha + db * beta


def _add_union(dest, matrix_a, matrix_b, alpha: float, beta: float) -> None:
    """alpha*A + beta*B on the pattern union, installed into ``dest``
    (matrix_a itself for `add`, a fresh matrix for `added`): each new
    bin starts at zero, A's scaled blocks land first, then B's are
    added, so a block in both sums in A-then-B order."""
    new_keys = np.union1d(matrix_a.keys, matrix_b.keys)
    rows = (new_keys // matrix_a.nblkcols).astype(np.int64)
    cols = (new_keys % matrix_a.nblkcols).astype(np.int64)
    nb, nsl, shapes = _bin_entries(matrix_a.row_blk_sizes, matrix_a.col_blk_sizes,
                                   rows, cols)
    counts = np.bincount(nb, minlength=len(shapes))
    dev = matrix_a.device
    pos_a = np.searchsorted(new_keys, matrix_a.keys)
    pos_b = np.searchsorted(new_keys, matrix_b.keys)
    bins = []
    for b_id, shape in enumerate(shapes):
        data = torch.zeros((int(counts[b_id]),) + shape, dtype=matrix_a.dtype, device=dev)
        for src, pos, fac in ((matrix_a, pos_a, alpha), (matrix_b, pos_b, beta)):
            src_ent = np.nonzero(nb[pos] == b_id)[0]
            if not len(src_ent):
                continue
            blocks = src.bins[src.ent_bin[src_ent[0]]].data[to_index(src.ent_slot[src_ent], dev)]
            data.index_add_(0, to_index(nsl[pos[src_ent]], dev), blocks * fac)
        bins.append(_Bin(shape, data, int(counts[b_id])))
    dest.set_structure_from_device(new_keys, bins, binning=(nb, nsl, shapes))


def add(matrix_a: BlockSparseMatrix, matrix_b: BlockSparseMatrix,
        alpha_scalar=1.0, beta_scalar=1.0) -> BlockSparseMatrix:
    """In-place A <- alpha*A + beta*B with pattern union (ref `dbcsr_add`,
    `dbcsr_operations.F:608`).  Same-pattern operands skip the index
    rebuild: one elementwise axpby per bin."""
    _add_checks(matrix_a, matrix_b)
    alpha = _scalar(alpha_scalar, matrix_a.dtype)
    beta = _scalar(beta_scalar, matrix_a.dtype)
    if _add_aligned(matrix_a, matrix_b):
        for ba, bb in zip(matrix_a.bins, matrix_b.bins):
            ba.data = _axpby(ba.data, bb.data, alpha, beta)
        matrix_a._bins_shared = False  # fresh tensors: its own again
        matrix_a._dense_canvas = None
        matrix_a._note_mutation(matrix_a.keys)
        return matrix_a
    _add_union(matrix_a, matrix_a, matrix_b, alpha, beta)
    return matrix_a


def added(matrix_a: BlockSparseMatrix, matrix_b: BlockSparseMatrix,
          alpha_scalar=1.0, beta_scalar=1.0,
          name: Optional[str] = None) -> BlockSparseMatrix:
    """Out-of-place alpha*A + beta*B into a fresh matrix, leaving both
    operands as they were (the models' convergence difference)."""
    _add_checks(matrix_a, matrix_b)
    out = BlockSparseMatrix(name or f"{matrix_a.name}+{matrix_b.name}",
                            matrix_a.row_blk_sizes, matrix_a.col_blk_sizes,
                            matrix_a.dtype, matrix_a.dist, matrix_a.matrix_type,
                            device=matrix_a.device)
    alpha = _scalar(alpha_scalar, matrix_a.dtype)
    beta = _scalar(beta_scalar, matrix_a.dtype)
    if _add_aligned(matrix_a, matrix_b):
        bins = [_Bin(ba.shape, _axpby(ba.data, bb.data, alpha, beta), ba.count)
                for ba, bb in zip(matrix_a.bins, matrix_b.bins)]
        out.set_structure_from_device(
            matrix_a.keys.copy(), bins,
            binning=(matrix_a.ent_bin.copy(), matrix_a.ent_slot.copy(),
                     [b.shape for b in bins]))
        return out
    _add_union(out, matrix_a, matrix_b, alpha, beta)
    return out


def copy(matrix: BlockSparseMatrix, name: Optional[str] = None) -> BlockSparseMatrix:
    """Ref `dbcsr_copy`."""
    return matrix.copy(name)


def set_value(matrix: BlockSparseMatrix, alpha) -> BlockSparseMatrix:
    """Set every stored element to ``alpha`` (ref `dbcsr_set`,
    `dbcsr_operations.F:2840`; the pattern is unchanged)."""
    _require_valid(matrix)
    a = _scalar(alpha, matrix.dtype)
    matrix.own_bins()
    for b in matrix.bins:
        b.data.fill_(a)
    matrix._note_mutation(matrix.keys)
    return matrix


def copy_into_existing(matrix_b: BlockSparseMatrix,
                       matrix_a: BlockSparseMatrix) -> BlockSparseMatrix:
    """Copy A's data into B, keeping B's pattern (ref
    `dbcsr_copy_into_existing`, `dbcsr_operations.F:1352`): blocks in
    both are copied, B's blocks absent in A are zeroed, A's blocks
    absent in B are skipped.  One gather of A and one scatter into B per
    bin, in place on B's bins."""
    _require_valid(matrix_a, matrix_b)
    _same_blocking(matrix_a, matrix_b)
    if matrix_a.matrix_type != matrix_b.matrix_type:
        # the reference's symmetric special case folds a general matrix
        # onto a symmetric pattern; here the stricter side is
        # desymmetrized first, as in the JAX package
        raise ValueError("copy_into_existing requires matching matrix types; "
                         "desymmetrize first")
    if matrix_a.dtype != matrix_b.dtype:
        raise ValueError("matrices have different data types")
    pos = np.searchsorted(matrix_a.keys, matrix_b.keys)
    pos_c = np.minimum(pos, max(len(matrix_a.keys) - 1, 0))
    in_a = (np.zeros(len(matrix_b.keys), bool) if len(matrix_a.keys) == 0
            else matrix_a.keys[pos_c] == matrix_b.keys)
    # gather every bin's blocks of A before B is written: A may be B
    gathered = []
    for b_id, b in enumerate(matrix_b.bins):
        ent = np.nonzero((matrix_b.ent_bin == b_id) & in_a)[0]
        blocks = None
        if len(ent):
            src = matrix_a.bins[matrix_a.ent_bin[pos_c[ent[0]]]].data
            blocks = src[to_index(matrix_a.ent_slot[pos_c[ent]], src.device)]
        gathered.append((ent, blocks))
    matrix_b.own_bins()
    for b, (ent, blocks) in zip(matrix_b.bins, gathered):
        b.data.zero_()
        if blocks is not None:
            b.data[to_index(matrix_b.ent_slot[ent], b.data.device)] = blocks
    matrix_b._note_mutation(matrix_b.keys)  # every stored value rewritten
    return matrix_b


def clear(matrix: BlockSparseMatrix) -> BlockSparseMatrix:
    """Remove all blocks, keeping blocking, distribution and type (ref
    `dbcsr_clear`, `dbcsr_operations.F:2571`)."""
    matrix.set_structure_from_device(np.empty(0, np.int64), [])
    return matrix


# ---------------------------------------------------------------- reductions
def _diag_entries(matrix: BlockSparseMatrix, b_id: int, rows, cols):
    """(entry indices, slots, block rows) of this bin's diagonal blocks."""
    sel = np.nonzero((matrix.ent_bin == b_id) & (rows == cols))[0]
    return sel, matrix.ent_slot[sel], rows[sel]


def _host_scalar(t: torch.Tensor):
    """A device scalar on the host: a complex for a complex tensor."""
    return complex(t) if t.is_complex() else float(t)


def trace(matrix: BlockSparseMatrix):
    """tr(A) (ref `dbcsr_trace`): one gather and diagonal sum per bin; a
    complex for a complex kind."""
    _require_valid(matrix)
    rows, cols = matrix.entry_coords()
    total = 0.0
    for b_id, b in enumerate(matrix.bins):
        sel, slots, _ = _diag_entries(matrix, b_id, rows, cols)
        if not len(sel):
            continue
        d = min(b.shape)
        blocks = b.data[to_index(slots, matrix.device)][:, :d, :d]
        total += _host_scalar(torch.diagonal(blocks, dim1=1, dim2=2).sum())
    return total


def dot(matrix_a: BlockSparseMatrix, matrix_b: BlockSparseMatrix):
    """tr(A^T B) = sum_ij A_ij B_ij (ref `dbcsr_dot`), a complex for a
    complex kind (no conjugation, as in the JAX package).  A symmetric
    pair's stored off-diagonal blocks count twice (S.S and A.A both
    reproduce +A_ij*B_ij in the lower triangle; H.H reproduces its
    conjugate); mixed kinds are desymmetrized first."""
    _require_valid(matrix_a, matrix_b)
    _same_blocking(matrix_a, matrix_b)
    if matrix_a.matrix_type != matrix_b.matrix_type:
        from dbcsr_tpu_torch.ops.transformations import desymmetrize

        return dot(desymmetrize(matrix_a), desymmetrize(matrix_b))
    common = np.intersect1d(matrix_a.keys, matrix_b.keys)
    offdiag = (common // matrix_a.nblkcols) != (common % matrix_a.nblkcols)
    pos_a = np.searchsorted(matrix_a.keys, common)
    pos_b = np.searchsorted(matrix_b.keys, common)
    dev = matrix_a.device
    total = 0.0
    for b_id, b in enumerate(matrix_a.bins):
        ent = np.nonzero(matrix_a.ent_bin[pos_a] == b_id)[0]
        if not len(ent):
            continue
        a_blk = b.data[to_index(matrix_a.ent_slot[pos_a[ent]], dev)]
        bb = matrix_b.bins[matrix_b.ent_bin[pos_b[ent[0]]]]
        b_blk = bb.data[to_index(matrix_b.ent_slot[pos_b[ent]], dev)]
        part = (a_blk * b_blk).sum(dim=(1, 2))
        if matrix_a.matrix_type == NO_SYMMETRY:
            total += _host_scalar(part.sum())
        else:
            p = to_host(part).astype(np.complex128)
            low = p[offdiag[ent]]
            if matrix_a.matrix_type == HERMITIAN:
                low = low.conj()  # the implicit lower term conj(A_ij) conj(B_ij)
            total += complex(p.sum()) + complex(low.sum())
    if not matrix_a.dtype.is_complex:
        total = float(np.real(total))
    return total


def frobenius_norm(matrix: BlockSparseMatrix) -> float:
    """||A||_F (ref `dbcsr_frobenius_norm`); a symmetric kind's stored
    off-diagonal blocks count twice."""
    _require_valid(matrix)
    norms = matrix.block_norms()
    if matrix.matrix_type == NO_SYMMETRY:
        return float(np.sqrt((norms ** 2).sum()))
    rows, cols = matrix.entry_coords()
    return float(np.sqrt((np.where(rows == cols, 1.0, 2.0) * norms ** 2).sum()))


def maxabs_norm(matrix: BlockSparseMatrix) -> float:
    """max |a_ij| (ref `dbcsr_maxabs_norm`)."""
    _require_valid(matrix)
    best = 0.0
    for b in matrix.bins:
        if b.count:
            best = max(best, float(b.data.abs().max()))
    return best


def gershgorin_norm(matrix: BlockSparseMatrix) -> float:
    """max_i sum_j |a_ij| (ref `dbcsr_gershgorin_norm`).  A symmetric
    kind is desymmetrized first, so the mirror of each stored
    off-diagonal block adds to its own rows, as in the JAX package.
    Each bin's per-block row sums of |a| come from one device reduction;
    the host adds them into the rows in entry order."""
    from dbcsr_tpu_torch.ops.transformations import desymmetrize

    m = desymmetrize(matrix) if matrix.matrix_type != NO_SYMMETRY else matrix
    _require_valid(m)
    row_sums = np.zeros(m.nfullrows, np.float64)
    rows, _ = m.entry_coords()
    row_off = m.row_blk_offsets
    for b_id, b in enumerate(m.bins):
        sel = np.nonzero(m.ent_bin == b_id)[0]
        if not len(sel):
            continue
        blocks = b.data[to_index(m.ent_slot[sel], m.device)]
        partial = to_host(blocks.abs().sum(dim=2)).astype(np.float64)  # (S, bm)
        idx = row_off[rows[sel]][:, None] + np.arange(b.shape[0])[None, :]
        np.add.at(row_sums, idx.ravel(), partial.ravel())
    return float(row_sums.max(initial=0.0))


def column_norms(matrix: BlockSparseMatrix) -> np.ndarray:
    """The 2-norm of every full column (ref `dbcsr_norm_col`): each bin's
    per-block column sums of |a|^2 from one device reduction in the
    matrix dtype, added into the columns on the host in entry order, as
    the JAX package adds them."""
    from dbcsr_tpu_torch.ops.transformations import desymmetrize

    m = desymmetrize(matrix) if matrix.matrix_type != NO_SYMMETRY else matrix
    _require_valid(m)
    col_sq = np.zeros(m.nfullcols, np.float64)
    _, cols = m.entry_coords()
    col_off = m.col_blk_offsets
    for b_id, b in enumerate(m.bins):
        sel = np.nonzero(m.ent_bin == b_id)[0]
        if not len(sel):
            continue
        blocks = b.data[to_index(m.ent_slot[sel], m.device)]
        partial = to_host((blocks.abs() ** 2).sum(dim=1)).astype(np.float64)  # (S, bn)
        idx = col_off[cols[sel]][:, None] + np.arange(b.shape[1])[None, :]
        np.add.at(col_sq, idx.ravel(), partial.ravel())
    return np.sqrt(col_sq)


# ----------------------------------------------------------------- diagonal
def get_diag(matrix: BlockSparseMatrix) -> np.ndarray:
    """Diagonal elements (ref `dbcsr_get_diag`): one batched gather per
    shape bin."""
    _require_valid(matrix)
    n = min(matrix.nfullrows, matrix.nfullcols)
    out = np.zeros(n, dtype=host_dtype(matrix.dtype))
    row_off = matrix.row_blk_offsets
    rows, cols = matrix.entry_coords()
    for b_id, b in enumerate(matrix.bins):
        sel, slots, rws = _diag_entries(matrix, b_id, rows, cols)
        if not len(sel):
            continue
        d = min(b.shape)
        diags = to_host(torch.diagonal(b.data[to_index(slots, matrix.device)][:, :d, :d],
                                       dim1=1, dim2=2))
        idx = row_off[rws][:, None] + np.arange(d)[None, :]
        ok = idx < n
        out[idx[ok]] = diags[ok]
    return out


def set_diag(matrix: BlockSparseMatrix, values) -> BlockSparseMatrix:
    """Set the diagonal elements of the stored diagonal blocks (ref
    `dbcsr_set_diag`): one batched scatter per shape bin.  A diagonal
    block straddling the short edge of a non-square matrix gets only its
    in-range prefix written."""
    _require_valid(matrix)
    v = np.asarray(values)
    n = min(matrix.nfullrows, matrix.nfullcols)
    row_off = matrix.row_blk_offsets
    rows, cols = matrix.entry_coords()
    matrix.own_bins()
    for b_id, b in enumerate(matrix.bins):
        sel, slots, rws = _diag_entries(matrix, b_id, rows, cols)
        if not len(sel):
            continue
        d = min(b.shape)
        diag = torch.diagonal(b.data, dim1=1, dim2=2)  # (count, d) view
        slots_t = to_index(slots, matrix.device)
        vals = to_host(diag[slots_t]).astype(host_dtype(matrix.dtype))
        idx = row_off[rws][:, None] + np.arange(d)[None, :]
        ok = idx < n
        vals[ok] = v[idx[ok]]
        diag[slots_t] = torch.from_numpy(vals).to(device=matrix.device, dtype=matrix.dtype)
    matrix._note_mutation(matrix.keys[rows == cols])
    return matrix


def reserve_blocks(matrix: BlockSparseMatrix, rows, cols) -> BlockSparseMatrix:
    """Ensure the listed blocks exist, zero where absent (ref
    `dbcsr_reserve_blocks`, `dbcsr_block_access.F:493`).  Present blocks
    are filtered out first, so an iteration whose pattern is steady pays
    a host index check only."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    if len(rows) == 0:
        return matrix.finalize()
    if matrix.matrix_type != NO_SYMMETRY:
        fold = rows > cols
        rows, cols = np.where(fold, cols, rows), np.where(fold, rows, cols)
    keys = rows * matrix.nblkcols + cols
    uniq, first = np.unique(keys, return_index=True)
    rows, cols = rows[first], cols[first]
    if matrix.valid and len(matrix.keys):
        pos = np.minimum(np.searchsorted(matrix.keys, uniq), len(matrix.keys) - 1)
        missing = matrix.keys[pos] != uniq
        if not missing.any():
            return matrix
        rows, cols = rows[missing], cols[missing]
    hdt = host_dtype(matrix.dtype)
    matrix.put_blocks(rows, cols,
                      [np.zeros(matrix.block_shape(r, c), hdt) for r, c in zip(rows, cols)],
                      summation=True)
    return matrix.finalize()


def reserve_diag_blocks(matrix: BlockSparseMatrix) -> BlockSparseMatrix:
    """Reserve every diagonal block (ref `dbcsr_reserve_diag_blocks`,
    `dbcsr_block_access.F:451`)."""
    idx = np.arange(min(matrix.nblkrows, matrix.nblkcols), dtype=np.int64)
    return reserve_blocks(matrix, idx, idx)


def reserve_all_blocks(matrix: BlockSparseMatrix) -> BlockSparseMatrix:
    """Reserve every block, the full pattern (ref
    `dbcsr_reserve_all_blocks`, `dbcsr_block_access.F:391`); a symmetric
    kind's canonical triangle only."""
    rows, cols = np.divmod(np.arange(matrix.nblkrows * matrix.nblkcols, dtype=np.int64),
                           matrix.nblkcols)
    if matrix.matrix_type != NO_SYMMETRY:
        keep = rows <= cols
        rows, cols = rows[keep], cols[keep]
    return reserve_blocks(matrix, rows, cols)


def hadamard_product(matrix_a: BlockSparseMatrix, matrix_b: BlockSparseMatrix,
                     name: str = "hadamard") -> BlockSparseMatrix:
    """C = A .* B on the intersection of the patterns (ref
    `dbcsr_hadamard_product`, `dbcsr_operations.F:971`): one product of
    two gathers per bin.  Symmetric operands are desymmetrized first
    (an elementwise product changes the symmetry class), so the result
    is a plain matrix."""
    _require_valid(matrix_a, matrix_b)
    _same_blocking(matrix_a, matrix_b)
    if matrix_a.matrix_type != NO_SYMMETRY or matrix_b.matrix_type != NO_SYMMETRY:
        from dbcsr_tpu_torch.ops.transformations import desymmetrize

        return hadamard_product(desymmetrize(matrix_a), desymmetrize(matrix_b), name)
    common = np.intersect1d(matrix_a.keys, matrix_b.keys)
    out = BlockSparseMatrix(name, matrix_a.row_blk_sizes, matrix_a.col_blk_sizes,
                            matrix_a.dtype, matrix_a.dist, NO_SYMMETRY, device=matrix_a.device)
    pos_a = np.searchsorted(matrix_a.keys, common)
    pos_b = np.searchsorted(matrix_b.keys, common)
    rows = (common // matrix_a.nblkcols).astype(np.int64)
    cols = (common % matrix_a.nblkcols).astype(np.int64)
    nb, nsl, shapes = _bin_entries(matrix_a.row_blk_sizes, matrix_a.col_blk_sizes, rows, cols)
    dev = matrix_a.device
    bins = []
    for b_id, shape in enumerate(shapes):
        ent = np.nonzero(nb == b_id)[0]
        xa = matrix_a.bins[matrix_a.ent_bin[pos_a[ent[0]]]].data
        xb = matrix_b.bins[matrix_b.ent_bin[pos_b[ent[0]]]].data
        prod = xa[to_index(matrix_a.ent_slot[pos_a[ent]], dev)] * \
            xb[to_index(matrix_b.ent_slot[pos_b[ent]], dev)]
        data = torch.empty((len(ent),) + shape, dtype=matrix_a.dtype, device=dev)
        data[to_index(nsl[ent], dev)] = prod
        bins.append(_Bin(shape, data, len(ent)))
    out.set_structure_from_device(common, bins, binning=(nb, nsl, shapes))
    return out


def add_on_diag(matrix: BlockSparseMatrix, alpha) -> BlockSparseMatrix:
    """A <- A + alpha*I, creating missing diagonal blocks (ref
    `dbcsr_add_on_diag`): one scatter-add of alpha onto the diagonals
    per shape bin."""
    _require_valid(matrix)
    n = min(matrix.nblkrows, matrix.nblkcols)
    if not np.array_equal(matrix.row_blk_sizes[:n], matrix.col_blk_sizes[:n]):
        raise ValueError("add_on_diag needs square diagonal blocks")
    idx = np.arange(n, dtype=np.int64)
    reserve_blocks(matrix, idx, idx)
    a = _scalar(alpha, matrix.dtype)
    rows, cols = matrix.entry_coords()
    matrix.own_bins()
    for b_id, b in enumerate(matrix.bins):
        sel, slots, _ = _diag_entries(matrix, b_id, rows, cols)
        if not len(sel):
            continue
        diag = torch.diagonal(b.data, dim1=1, dim2=2)  # (count, d) view
        slots_t = to_index(slots, matrix.device)
        diag[slots_t] = diag[slots_t] + a
    matrix._note_mutation(matrix.keys[rows == cols])
    return matrix


def _swap_state(matrix: BlockSparseMatrix, replacement: BlockSparseMatrix) -> None:
    """Give ``matrix`` the state of ``replacement`` in place, keeping its
    own mutation epoch and journaling a change of structure (the epoch
    must stay monotone for the incremental multiply)."""
    epoch = matrix._epoch
    matrix.__dict__.update(replacement.__dict__)
    matrix._epoch = epoch
    matrix._note_mutation(None)


def triu(matrix: BlockSparseMatrix) -> BlockSparseMatrix:
    """In-place block upper triangle (ref `dbcsr_triu`,
    `dbcsr_operations.F:1849-1885`): blocks below the block diagonal are
    dropped and the strictly lower elements of diagonal blocks zeroed.
    A symmetric kind becomes the plain matrix first."""
    _require_valid(matrix)
    if matrix.matrix_type != NO_SYMMETRY:
        from dbcsr_tpu_torch.ops.transformations import desymmetrize

        _swap_state(matrix, desymmetrize(matrix, name=matrix.name))
    rows, cols = matrix.entry_coords()
    compress(matrix, rows <= cols)
    rows, cols = matrix.entry_coords()
    diag = np.nonzero(rows == cols)[0]
    matrix.own_bins()
    for b_id, b in enumerate(matrix.bins):
        sel = diag[matrix.ent_bin[diag] == b_id]
        if len(sel):
            slots = to_index(matrix.ent_slot[sel], matrix.device)
            b.data[slots] = torch.triu(b.data[slots])
    matrix._note_mutation(matrix.keys[diag])
    return matrix


def verify_matrix(matrix: BlockSparseMatrix, check_data: bool = True) -> bool:
    """Structural invariant check (ref `dbcsr_verify_matrix`,
    `dbcsr_dist_util.F:578-732`); raises ValueError on a violation (a
    raise, not an assert, so the check survives ``python -O``)."""

    def _check(cond, msg):
        if not cond:
            raise ValueError(f"verify_matrix({matrix.name}): {msg}")

    _require_valid(matrix)
    keys = matrix.keys
    _check(np.all(np.diff(keys) > 0), "index keys not strictly sorted")
    nb = matrix.nblkrows * matrix.nblkcols
    _check(len(keys) == 0 or (keys[0] >= 0 and keys[-1] < nb), "key out of range")
    rows, cols = matrix.entry_coords()
    counts = np.bincount(rows, minlength=matrix.nblkrows)
    _check(np.array_equal(np.diff(matrix.row_ptr), counts), "row_ptr inconsistent")
    _check(len(matrix.ent_bin) == len(keys) and len(matrix.ent_slot) == len(keys),
           "entry->bin maps length mismatch")
    for b_id, b in enumerate(matrix.bins):
        sel = matrix.ent_bin == b_id
        slots = matrix.ent_slot[sel]
        _check(len(np.unique(slots)) == len(slots), f"bin {b_id} slot collision")
        _check(b.count == int(sel.sum()), f"bin {b_id} count mismatch")
        _check(b.data.shape[0] >= b.count, f"bin {b_id} capacity < count")
        _check(slots.size == 0 or slots.max() < b.count, f"bin {b_id} slot >= count")
        bm, bn = b.shape
        _check(np.all(matrix.row_blk_sizes[rows[sel]] == bm), f"bin {b_id} row size")
        _check(np.all(matrix.col_blk_sizes[cols[sel]] == bn), f"bin {b_id} col size")
    if matrix.matrix_type != NO_SYMMETRY:
        _check(np.all(rows <= cols), "symmetric matrix stores lower-triangle block")
    if check_data:
        for b in matrix.bins:
            if b.count:
                _check(bool(torch.isfinite(b.data).all()), "non-finite block data")
    return True
