"""Element-level CSR conversions.

Counterpart of `dbcsr_tpu/ops/csr.py` (ref
`src/ops/dbcsr_csr_conversions.F`: csr_type :115-143,
`csr_create_from_dbcsr` :762, `convert_csr_to_dbcsr` :377): conversion
between the block-sparse format and a scipy-style element CSR
(indptr, indices, data as host arrays), the PEXSI/SuperLU interop path,
and `complete_redistribute`, which re-blocks through element
coordinates.  The element scatter into block buffers runs in the
native engine (`native.coo_fill_blocks`), or in NumPy under
``DBCSR_TPU_TORCH_NATIVE=0``; `mm.multiply.read_totals` counts which.
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

import numpy as np
import torch

from dbcsr_tpu_torch import native
from dbcsr_tpu_torch.core.kinds import dtype_of, host_dtype
from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY, BlockSparseMatrix, to_host
from dbcsr_tpu_torch.device import DeviceLike
from dbcsr_tpu_torch.ops.transformations import desymmetrize


def csr_from_matrix(matrix: BlockSparseMatrix, keep_zeros: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Block-sparse -> element CSR (indptr, indices, data): stored blocks
    element by element (zeros inside stored blocks kept only with
    ``keep_zeros``), sorted row-major; a symmetric kind is unfolded."""
    m = desymmetrize(matrix) if matrix.matrix_type != NO_SYMMETRY else matrix
    if not m.valid:
        raise RuntimeError("finalize() first")
    row_off = m.row_blk_offsets
    col_off = m.col_blk_offsets
    rows_l, cols_l, vals_l = [], [], []
    ent_rows, ent_cols = m.entry_coords()
    for b_id, b in enumerate(m.bins):
        mask = m.ent_bin == b_id
        if not mask.any():
            continue
        bm, bn = b.shape
        blocks = to_host(b.data[: b.count])[m.ent_slot[mask]]
        er = row_off[ent_rows[mask]][:, None, None] + np.arange(bm)[None, :, None]
        ec = col_off[ent_cols[mask]][:, None, None] + np.arange(bn)[None, None, :]
        rows_l.append(np.broadcast_to(er, blocks.shape).reshape(-1))
        cols_l.append(np.broadcast_to(ec, blocks.shape).reshape(-1))
        vals_l.append(blocks.reshape(-1))
    if rows_l:
        rows, cols, vals = (np.concatenate(x) for x in (rows_l, cols_l, vals_l))
    else:
        rows = np.empty(0, np.int64)
        cols = np.empty(0, np.int64)
        vals = np.empty(0, host_dtype(m.dtype))
    if not keep_zeros:
        nz = vals != 0
        rows, cols, vals = rows[nz], cols[nz], vals[nz]
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(m.nfullrows + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, cols.astype(np.int64), vals


def _fill_blocks(blk_of_entry, lr, lc, vals, offsets, bns, flat) -> None:
    """The element scatter of `matrix_from_csr`, native unless
    ``DBCSR_TPU_TORCH_NATIVE=0`` asks for NumPy; counted in
    ``read_totals()["index_engine"]["coo_fill"]``."""
    from dbcsr_tpu_torch.mm import multiply as mm

    if native.enabled():
        native.coo_fill_blocks(blk_of_entry, lr, lc, vals, offsets, bns, flat)
        mm._totals["index_engine"]["coo_fill"]["native"] += 1
        return
    flat[offsets[blk_of_entry] + lr * bns[blk_of_entry] + lc] = vals
    mm._totals["index_engine"]["coo_fill"]["numpy"] += 1


def matrix_from_csr(name: str, indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                    row_blk_sizes, col_blk_sizes, dist=None,
                    device: Optional[DeviceLike] = None) -> BlockSparseMatrix:
    """Element CSR -> block-sparse on ``device``: a block is stored iff it
    holds a structural entry (ref `convert_csr_to_dbcsr`).  The blocks
    are assembled on the host, then staged one batch per block shape."""
    data = np.asarray(data)
    out = BlockSparseMatrix(name, row_blk_sizes, col_blk_sizes, dtype_of(data.dtype), dist,
                            device=device)
    if out.nfullrows != len(indptr) - 1:
        raise ValueError("indptr length != full rows")
    row_off = out.row_blk_offsets
    col_off = out.col_blk_offsets
    erows = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    ecols = np.asarray(indices, np.int64)
    if len(ecols) != len(erows) or len(data) != len(erows):
        raise ValueError("indptr, indices and data disagree in length")
    if len(ecols) and (ecols.min() < 0 or ecols.max() >= out.nfullcols):
        raise ValueError("column index out of range")
    brow = np.searchsorted(row_off, erows, side="right") - 1
    bcol = np.searchsorted(col_off, ecols, side="right") - 1
    bkey = brow * out.nblkcols + bcol
    uniq, blk_of_entry = np.unique(bkey, return_inverse=True)
    ur, uc = np.divmod(uniq, out.nblkcols)
    bms = out.row_blk_sizes[ur].astype(np.int64)
    bns = out.col_blk_sizes[uc].astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(bms * bns)])
    flat = np.zeros(int(offsets[-1]), data.dtype)
    _fill_blocks(blk_of_entry.astype(np.int64), erows - row_off[brow], ecols - col_off[bcol],
                 np.ascontiguousarray(data), offsets[:-1], bns, flat)
    code = bms << 32 | bns
    for u in np.unique(code):
        sel = np.nonzero(code == u)[0]
        bm, bn = int(u >> 32), int(u & 0xFFFFFFFF)
        idx = offsets[sel][:, None] + np.arange(bm * bn)[None, :]
        out.put_blocks(ur[sel], uc[sel], flat[idx].reshape(len(sel), bm, bn))
    return out.finalize()


def complete_redistribute(matrix: BlockSparseMatrix, row_blk_sizes, col_blk_sizes, dist=None,
                          name: Optional[str] = None) -> BlockSparseMatrix:
    """Re-block a matrix onto any new blocking of the same element space
    (ref `dbcsr_complete_redistribute`, `dbcsr_transformations.F:1546`),
    through element coordinates, on the matrix's device."""
    new_rbs = np.asarray(row_blk_sizes, np.int32)
    new_cbs = np.asarray(col_blk_sizes, np.int32)
    if new_rbs.sum() != matrix.nfullrows or new_cbs.sum() != matrix.nfullcols:
        raise ValueError("new blocking covers a different element space")
    indptr, indices, data = csr_from_matrix(matrix, keep_zeros=True)
    return matrix_from_csr(name or matrix.name, indptr, indices, data, new_rbs, new_cbs, dist,
                           device=matrix.device)


# ------------------------------------------------------------- csr_type API
# row distributions of a CSR matrix over processes
# (ref `dbcsr_csr_conversions.F:70,769-799`)
CSR_DBCSR_BLKROW_DIST = 1  # whole DBCSR block rows per process
CSR_EQROW_CEIL_DIST = 2    # ceiling(N/P) rows per process
CSR_EQROW_FLOOR_DIST = 3   # floor(N/P) rows per process (the last takes the rest)


def csr_eqrow_ceil_dist(nrows: int, nbins: int) -> np.ndarray:
    """Row -> bin map with ceiling(N/P) rows per bin (ref
    csr_eqrow_ceil_dist)."""
    per = -(-nrows // max(nbins, 1))
    return np.minimum(np.arange(nrows, dtype=np.int64) // max(per, 1),
                      nbins - 1).astype(np.int32)


def csr_eqrow_floor_dist(nrows: int, nbins: int) -> np.ndarray:
    """Row -> bin map with floor(N/P) rows per bin; the last bin takes the
    remainder (ref csr_eqrow_floor_dist)."""
    per = max(nrows // max(nbins, 1), 1)
    return np.minimum(np.arange(nrows, dtype=np.int64) // per, nbins - 1).astype(np.int32)


def csr_blkrow_dist(matrix: BlockSparseMatrix, nbins: int) -> np.ndarray:
    """Row -> bin map that never splits a block row across bins (ref
    csr_dbcsr_blkrow_dist): block rows go to bins by their cumulative
    element-row count, balancing rows per bin."""
    sizes = matrix.row_blk_sizes.astype(np.int64)
    total = int(sizes.sum())
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    blk_bin = np.minimum(starts * nbins // max(total, 1), nbins - 1)
    return np.repeat(blk_bin, sizes).astype(np.int32)


class CsrMatrix:
    """Element CSR with an optional row distribution, the `csr_type`
    analog (ref `dbcsr_csr_conversions.F:115-143`)."""

    def __init__(self, nrows, ncols, indptr, indices, data, row_dist=None):
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.indptr = np.ascontiguousarray(indptr, np.int64)
        self.indices = np.ascontiguousarray(indices, np.int64)
        self.data = np.ascontiguousarray(data)
        self.row_dist = row_dist
        self.valid = True

    @property
    def nze(self) -> int:
        return len(self.data)


def csr_create_from_matrix(matrix: BlockSparseMatrix, nprocs: int = 1,
                           dist_format: int = CSR_EQROW_CEIL_DIST,
                           keep_zeros: bool = False) -> CsrMatrix:
    """Block-sparse -> `CsrMatrix` with a row distribution of the given
    format (ref `dbcsr_csr_create_from_dbcsr`,
    `dbcsr_csr_conversions.F:762`)."""
    indptr, indices, data = csr_from_matrix(matrix, keep_zeros=keep_zeros)
    nrows, ncols = matrix.nfullrows, matrix.nfullcols
    if dist_format == CSR_EQROW_CEIL_DIST:
        rd = csr_eqrow_ceil_dist(nrows, nprocs)
    elif dist_format == CSR_EQROW_FLOOR_DIST:
        rd = csr_eqrow_floor_dist(nrows, nprocs)
    elif dist_format == CSR_DBCSR_BLKROW_DIST:
        rd = csr_blkrow_dist(matrix, nprocs)
    else:
        raise ValueError(f"unknown dist_format {dist_format}")
    return CsrMatrix(nrows, ncols, indptr, indices, data, row_dist=rd)


def to_csr_filter(matrix: BlockSparseMatrix, eps: float) -> BlockSparseMatrix:
    """The 0/1 sparsity template of ``matrix``, elements with |x| < eps
    marked 0, to sparsify a CSR conversion (ref `dbcsr_to_csr_filter`,
    `dbcsr_csr_conversions.F:1027`)."""
    out = matrix.copy(name="CSR sparsity")
    if not out.valid:
        out.finalize()
    if eps > 0.0:
        out.map_bin_data(lambda d: (~(d.abs() < eps)).to(d.dtype))
    else:
        out.map_bin_data(lambda d: torch.ones_like(d))
    return out


def csr_write(csr: CsrMatrix, file, upper_triangle: bool = False, threshold: float = 0.0,
              binary: bool = False) -> None:
    """Write a CSR matrix: text lines "row col value" (1-based) or a raw
    binary dump (ref `csr_write`, `dbcsr_csr_conversions.F:1085`)."""
    if not csr.valid:
        raise RuntimeError("cannot write an invalid CSR matrix")
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), np.diff(csr.indptr))
    cols = csr.indices
    vals = csr.data
    keep = np.ones(len(vals), bool)
    if upper_triangle:
        keep &= cols >= rows
    if threshold > 0.0:
        keep &= np.abs(vals) >= threshold
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if binary:
        np.asarray([csr.nrows, csr.ncols, len(vals)], np.int64).tofile(file)
        rows.tofile(file)
        cols.tofile(file)
        vals.tofile(file)
        return
    if np.iscomplexobj(vals):
        for r, c, v in zip(rows, cols, vals):
            file.write(f"{r + 1} {c + 1} {v.real:.14E} {v.imag:.14E}\n")
    else:
        for r, c, v in zip(rows, cols, vals):
            file.write(f"{r + 1} {c + 1} {v:.14E}\n")


def csr_print_sparsity(csr: CsrMatrix, file=None) -> None:
    """Print the CSR non-zero count and percentage (ref
    `csr_print_sparsity`, `dbcsr_csr_conversions.F:1284`)."""
    out = file or sys.stdout
    pct = 100.0 * csr.nze / max(csr.nrows * csr.ncols, 1)
    print(f"{'Number of  CSR non-zero elements:':>48} {csr.nze:>13d}", file=out)
    print(f"{'Percentage CSR non-zero elements:':>48} {pct:>6.2f}", file=out)
