"""Randomized test utilities: the dense-oracle pattern.

Counterpart of `dbcsr_tpu/ops/test_methods.py` (ref
`src/ops/dbcsr_test_methods.F`).  `make_random_matrix` draws from the
numpy Generator in exactly the JAX package's order -- first the
``(nbr, nbc)`` occupancy draw, then one ``standard_normal(shape)`` per
present block in ``np.nonzero`` order -- so the same seed gives the same
matrix in both packages and the `.perf` checksum references hold.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.core.dist import Distribution
from dbcsr_tpu_torch.core.kinds import dtype_of, host_dtype
from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY, BlockSparseMatrix
from dbcsr_tpu_torch.device import DeviceLike


def make_random_matrix(
    name: str,
    row_blk_sizes,
    col_blk_sizes,
    dtype=torch.float64,
    occupation: float = 0.5,
    dist: Optional[Distribution] = None,
    matrix_type: str = NO_SYMMETRY,
    rng: Optional[np.random.Generator] = None,
    device: Optional[DeviceLike] = None,
) -> BlockSparseMatrix:
    """Random block-sparse matrix with ~``occupation`` block fill
    (ref `dbcsr_make_random_matrix`, `dbcsr_test_methods.F:70`)."""
    if rng is None:
        raise ValueError("pass a numpy Generator (rng=np.random.default_rng(seed))")
    m = BlockSparseMatrix(name, row_blk_sizes, col_blk_sizes, dtype, dist,
                          matrix_type, device=device)
    hdt = host_dtype(dtype_of(dtype))
    present = rng.random((m.nblkrows, m.nblkcols)) < occupation
    rows, cols = np.nonzero(present)
    for r, c in zip(rows, cols):
        m.put_block(r, c, rng.standard_normal(m.block_shape(r, c)).astype(hdt))
    return m.finalize()


def to_dense(matrix: BlockSparseMatrix) -> np.ndarray:
    """Densify on the host (ref `dbcsr_to_dense_local`)."""
    out = np.zeros((matrix.nfullrows, matrix.nfullcols), host_dtype(matrix.dtype))
    row_off = matrix.row_blk_offsets
    col_off = matrix.col_blk_offsets
    for r, c, blk in matrix.iterate_blocks():
        out[row_off[r]: row_off[r] + blk.shape[0],
            col_off[c]: col_off[c] + blk.shape[1]] = blk
    return out


def from_dense(name: str, dense: np.ndarray, row_blk_sizes, col_blk_sizes,
               dist: Optional[Distribution] = None, keep_zero_blocks: bool = False,
               dtype=None, device: Optional[DeviceLike] = None) -> BlockSparseMatrix:
    """Blocked matrix from a dense array, dropping all-zero blocks."""
    m = BlockSparseMatrix(name, row_blk_sizes, col_blk_sizes,
                          dense.dtype if dtype is None else dtype, dist,
                          device=device)
    row_off = m.row_blk_offsets
    col_off = m.col_blk_offsets
    for r in range(m.nblkrows):
        for c in range(m.nblkcols):
            blk = dense[row_off[r]: row_off[r + 1], col_off[c]: col_off[c + 1]]
            if keep_zero_blocks or np.any(blk != 0):
                m.put_block(r, c, blk)
    return m.finalize()


def checksum(matrix: BlockSparseMatrix, pos: bool = False) -> float:
    """Scalar checksum (ref `dbcsr_checksum`, `src/dist/dbcsr_dist_util.F:431`):
    the sum of squares of the stored elements from the per-block norms,
    or with ``pos`` the position-dependent variant (`pd_blk_cs`,
    `dbcsr_dist_util.F:551`): sum of a[r,c] * log(grow * gcol) over
    1-based global element coordinates, one float64 device reduction
    per bin."""
    if not pos:
        norms = matrix.block_norms().astype(np.float64)
        return float((norms ** 2).sum())
    row_off = matrix.row_blk_offsets
    col_off = matrix.col_blk_offsets
    rows, cols = matrix.entry_coords()
    total = 0.0
    for b_id, b in enumerate(matrix.bins):
        if b.count == 0:
            continue
        mask = matrix.ent_bin == b_id
        slots = matrix.ent_slot[mask]
        ro = np.zeros(b.count, np.float64)
        co = np.zeros(b.count, np.float64)
        ro[slots] = row_off[rows[mask]]
        co[slots] = col_off[cols[mask]]
        dev = b.data.device
        bm, bn = b.shape
        grow = (torch.from_numpy(ro).to(dev)[:, None, None] + 1.0
                + torch.arange(bm, dtype=torch.float64, device=dev)[None, :, None])
        gcol = (torch.from_numpy(co).to(dev)[:, None, None] + 1.0
                + torch.arange(bn, dtype=torch.float64, device=dev)[None, None, :])
        w = torch.log(torch.abs(grow * gcol))
        total += float((b.data[: b.count].to(torch.float64) * w).sum())
    return total
