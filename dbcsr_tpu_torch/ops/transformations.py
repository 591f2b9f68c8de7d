"""Structure transformations: the out-of-place transpose and
desymmetrization.

Counterpart of `dbcsr_tpu/ops/transformations.py` (ref
`dbcsr_new_transposed`, `src/ops/dbcsr_transformations.F:113`, and
`dbcsr_desymmetrize_deep`, :307).  The index permutation happens on the
host; block data moves in one gather (plus a batched transpose where a
block changes side) per shape bin on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.core.matrix import (
    ANTISYMMETRIC,
    HERMITIAN,
    NO_SYMMETRY,
    BlockSparseMatrix,
    _Bin,
    _bin_entries,
    to_index,
)


def new_transposed(matrix: BlockSparseMatrix, conjugate: bool = False,
                   name: Optional[str] = None) -> BlockSparseMatrix:
    """Out-of-place transpose (ref `dbcsr_new_transposed`), conjugated
    with ``conjugate`` (the "C" operand of a complex multiply); a
    symmetric kind is desymmetrized first, as in the JAX package."""
    if not matrix.valid:
        raise RuntimeError("finalize() before transposing")
    m = desymmetrize(matrix) if matrix.matrix_type != NO_SYMMETRY else matrix
    t = BlockSparseMatrix(name or (m.name + "^T"), m.col_blk_sizes,
                          m.row_blk_sizes, m.dtype, m.dist.transposed(),
                          NO_SYMMETRY, device=m.device)
    rows, cols = m.entry_coords()
    new_keys = cols * m.nblkrows + rows
    order = np.argsort(new_keys, kind="stable")
    t_keys = new_keys[order]
    old_bin = m.ent_bin[order]
    old_slot = m.ent_slot[order]
    nb, nsl, shapes = _bin_entries(t.row_blk_sizes, t.col_blk_sizes,
                                   cols[order], rows[order])
    bins = []
    for b, shape in enumerate(shapes):
        mask = nb == b
        count = int(mask.sum())
        src = m.bins[old_bin[mask][0]].data
        # slot p of the new bin holds old slot perm[p], transposed
        perm = np.empty(count, np.int64)
        perm[nsl[mask]] = old_slot[mask]
        data = src[torch.from_numpy(perm).to(src.device)].transpose(1, 2)
        if conjugate and data.is_complex():
            data = data.conj()
        data = data.contiguous().resolve_conj()
        bins.append(_Bin(shape, data, count))
    t.set_structure_from_device(t_keys, bins, binning=(nb, nsl, shapes))
    return t


def desymmetrize(matrix: BlockSparseMatrix, name: Optional[str] = None) -> BlockSparseMatrix:
    """Expand canonical triangular storage to a full non-symmetric matrix
    (ref `dbcsr_desymmetrize_deep`); a non-symmetric matrix is copied.

    The JAX package fetches every block and re-puts it and its mirror
    from the host; here each output bin is filled on the device by one
    gather of the stored blocks of its shape and one gather plus batched
    transpose (negated for an antisymmetric matrix) of the mirrored
    ones (conjugated for a hermitian kind), which gives the same values."""
    if not matrix.valid:
        raise RuntimeError("finalize() before desymmetrizing")
    if matrix.matrix_type == NO_SYMMETRY:
        return matrix.copy(name)
    m = matrix
    out = BlockSparseMatrix(name or (m.name + "_desym"), m.row_blk_sizes,
                            m.col_blk_sizes, m.dtype, m.dist, NO_SYMMETRY,
                            device=m.device)
    rows, cols = m.entry_coords()
    off = np.nonzero(rows != cols)[0]
    # every stored entry, then the mirror of each off-diagonal one
    src_ent = np.concatenate([np.arange(m.nblks), off])
    mirrored = np.concatenate([np.zeros(m.nblks, bool), np.ones(len(off), bool)])
    out_rows = np.concatenate([rows, cols[off]])
    out_cols = np.concatenate([cols, rows[off]])
    keys = out_rows * m.nblkcols + out_cols
    order = np.argsort(keys, kind="stable")
    keys, src_ent, mirrored = keys[order], src_ent[order], mirrored[order]
    nb, nsl, shapes = _bin_entries(m.row_blk_sizes, m.col_blk_sizes,
                                   out_rows[order], out_cols[order])
    counts = np.bincount(nb, minlength=len(shapes))
    sign = -1.0 if m.matrix_type == ANTISYMMETRIC else 1.0
    bins = []
    for b, shape in enumerate(shapes):
        data = torch.empty((int(counts[b]),) + shape, dtype=m.dtype, device=m.device)
        for flip in (False, True):
            sel = np.nonzero((nb == b) & (mirrored == flip))[0]
            if not len(sel):
                continue
            ent = src_ent[sel]
            src = m.bins[m.ent_bin[ent[0]]].data
            blocks = src[to_index(m.ent_slot[ent], m.device)]
            if flip:
                blocks = blocks.transpose(1, 2)
                if sign < 0:
                    blocks = -blocks
                if m.matrix_type == HERMITIAN:
                    blocks = blocks.conj().resolve_conj()
            data[to_index(nsl[sel], m.device)] = blocks
        bins.append(_Bin(shape, data, int(counts[b])))
    out.set_structure_from_device(keys, bins, binning=(nb, nsl, shapes))
    return out
