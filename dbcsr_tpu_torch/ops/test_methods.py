"""Randomized test utilities: the dense-oracle pattern.

Counterpart of `dbcsr_tpu/ops/test_methods.py` (ref
`src/ops/dbcsr_test_methods.F`).  `make_random_matrix` draws from the
numpy Generator in exactly the JAX package's order -- first the
``(nbr, nbc)`` occupancy draw (its upper triangle for a symmetric
kind), then one ``standard_normal(shape)`` per present block in
``np.nonzero`` order (a complex kind draws a second one for the
imaginary part right after it), a diagonal block averaged with its fold
-- so the same seed gives the same matrix in both packages and the
`.perf` checksum references hold.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.core.dist import Distribution
from dbcsr_tpu_torch.core.kinds import dtype_of, host_dtype
from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY, BlockSparseMatrix, _fold_block
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
    if m.matrix_type != NO_SYMMETRY:
        present = np.triu(present)
    rows, cols = np.nonzero(present)
    for r, c in zip(rows, cols):
        shape = m.block_shape(r, c)
        blk = rng.standard_normal(shape)
        if m.dtype.is_complex:
            blk = blk + 1j * rng.standard_normal(shape)
        if m.matrix_type != NO_SYMMETRY and r == c:
            blk = (blk + _fold_block(blk, m.matrix_type)) / 2  # consistent diagonal
        m.put_block(r, c, blk.astype(hdt))
    return m.finalize()


def to_dense(matrix: BlockSparseMatrix) -> np.ndarray:
    """Densify on the host (ref `dbcsr_to_dense_local`); a symmetric
    kind's stored blocks are unfolded into the other triangle."""
    out = np.zeros((matrix.nfullrows, matrix.nfullcols), host_dtype(matrix.dtype))
    row_off = matrix.row_blk_offsets
    col_off = matrix.col_blk_offsets
    for r, c, blk in matrix.iterate_blocks():
        out[row_off[r]: row_off[r] + blk.shape[0],
            col_off[c]: col_off[c] + blk.shape[1]] = blk
        if matrix.matrix_type != NO_SYMMETRY and r != c:
            out[col_off[c]: col_off[c] + blk.shape[1],
                row_off[r]: row_off[r] + blk.shape[0]] = _fold_block(blk, matrix.matrix_type)
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
    the sum of squares of the elements from the per-block norms (a
    symmetric kind's off-diagonal blocks counted twice), or with ``pos`` the position-dependent variant (`pd_blk_cs`,
    `dbcsr_dist_util.F:551`): sum of a[r,c] * log(grow * gcol) over
    1-based global element coordinates (the real part of a complex
    element), one float64 device reduction per bin over the stored
    blocks."""
    if not pos:
        norms = matrix.block_norms().astype(np.float64)
        if matrix.matrix_type != NO_SYMMETRY:
            rows, cols = matrix.entry_coords()
            return float((np.where(rows == cols, 1.0, 2.0) * norms ** 2).sum())
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
        ro_t = torch.from_numpy(ro).to(dev)[:, None, None] + 1.0
        co_t = torch.from_numpy(co).to(dev)[:, None, None] + 1.0
        ri = torch.arange(bm, dtype=torch.float64, device=dev)[None, :, None]
        ci = torch.arange(bn, dtype=torch.float64, device=dev)[None, None, :]
        # the weights of a bounded chunk of blocks at a time (a bin of a
        # large matrix would need several times its own size at once);
        # the chunks' sums add in chunk order
        per = max(1, (1 << 24) // (bm * bn))
        part = torch.zeros((), dtype=torch.float64, device=dev)
        for s0 in range(0, b.count, per):
            w = torch.log(torch.abs((ro_t[s0: s0 + per] + ri) * (co_t[s0: s0 + per] + ci)))
            blocks = b.data[s0: min(s0 + per, b.count)]
            if blocks.is_complex():
                blocks = blocks.real
            part += (blocks.to(torch.float64) * w).sum()
        total += float(part)
    return total
