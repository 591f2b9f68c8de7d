"""Structure transformations: the out-of-place transpose.

Counterpart of `dbcsr_tpu/ops/transformations.py` (ref
`dbcsr_new_transposed`, `src/ops/dbcsr_transformations.F:113`).  The
index permutation happens on the host; block data moves in one gather
plus transpose per shape bin on the device.  `desymmetrize` is not
ported yet (symmetric matrices raise at construction).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.core.matrix import (
    NO_SYMMETRY,
    BlockSparseMatrix,
    _Bin,
    _bin_entries,
)


def new_transposed(matrix: BlockSparseMatrix,
                   name: Optional[str] = None) -> BlockSparseMatrix:
    """Out-of-place transpose (ref `dbcsr_new_transposed`)."""
    if not matrix.valid:
        raise RuntimeError("finalize() before transposing")
    m = matrix
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
        data = src[torch.from_numpy(perm).to(src.device)].transpose(1, 2).contiguous()
        bins.append(_Bin(shape, data, count))
    t.set_structure_from_device(t_keys, bins, binning=(nb, nsl, shapes))
    return t
