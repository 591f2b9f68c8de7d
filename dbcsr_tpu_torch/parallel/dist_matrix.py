"""Distributed block-sparse matrices on the grid, dense panels.

Counterpart of `dbcsr_tpu/parallel/dist_matrix.py`: a matrix laid out
as a padded uniform-block dense canvas (each block padded to the
largest block shape, absent blocks zero) in one operand role of the
Cannon layout.  The zero padding keeps mixed block sizes exact: padded
k columns of A meet padded (zero) k rows of B.

* `distribute` (ref `make_m2s`, `dbcsr_mm_cannon.F:146`) builds the
  canvas on the grid's home device; the Cannon (`cannon.py`) cuts each
  image's panels from it by the role's layout.
* `collect` carves the canvas back into a block-sparse matrix against
  the original blocking (the `dbcsr_finalize` of per-rank results).
* `replicate` (ref `dbcsr_replicate_all`, `dbcsr_transformations.F:108`)
  is the full, row or column replication; ``spec`` records the role's
  layout as the JAX package's PartitionSpec does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.core import stats
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.core.timings import timed
from dbcsr_tpu_torch.obs import tracer as _trace
from dbcsr_tpu_torch.parallel.cannon import cannon_multiply_dense
from dbcsr_tpu_torch.parallel.mesh import Grid

# layout of each operand role over the grid axes, per canvas dimension
# (the JAX package's PartitionSpecs); "R" = fully replicated,
# "Rrow"/"Rcol" = replicated across grid rows/cols only (ref
# dbcsr_repl_none/row/col/full, `dbcsr_types.F:476-479`)
ROLE_SPECS = {
    "A": ("pr", ("kl", "pc")),
    "B": (("kl", "pr"), "pc"),
    "C": ("pr", "pc"),
    "R": (),
    "Rrow": (None, "pc"),
    "Rcol": ("pr", None),
}


@dataclasses.dataclass
class DistMatrix:
    data: torch.Tensor  # the padded canvas (nbr_pad*bm, nbc_pad*bn)
    row_blk_sizes: np.ndarray
    col_blk_sizes: np.ndarray
    bm: int
    bn: int
    nbr_pad: int
    nbc_pad: int
    mesh: Grid
    role: str
    name: str = "dist"
    dtype: object = torch.float64

    @property
    def nblkrows(self) -> int:
        return len(self.row_blk_sizes)

    @property
    def nblkcols(self) -> int:
        return len(self.col_blk_sizes)

    @property
    def spec(self) -> tuple:
        """The role's layout over the grid axes."""
        return ROLE_SPECS[self.role]


def _pad_counts(grid: Grid, role: str):
    """Block-count padding quanta per dim, derived from the role's layout
    (the product of the grid axis sizes laying out that dim)."""
    spec = ROLE_SPECS[role]

    def quantum(i):
        entry = spec[i] if len(spec) > i else None
        if entry is None:
            return 1
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for ax in axes:
            n *= grid.shape[ax]
        return n

    return quantum(0), quantum(1)


def distribute(matrix: BlockSparseMatrix, mesh: Grid, role: str = "A",
               name: Optional[str] = None) -> DistMatrix:
    """Lay a matrix out on the grid as a padded block-dense canvas."""
    if not matrix.valid:
        raise RuntimeError("finalize() before distributing")
    with timed("dist_distribute"):
        return _distribute_impl(matrix, mesh, role, name)


def _distribute_impl(matrix, grid, role, name) -> DistMatrix:
    from dbcsr_tpu_torch.core.matrix import to_index

    bm = int(matrix.row_blk_sizes.max()) if matrix.nblkrows else 1
    bn = int(matrix.col_blk_sizes.max()) if matrix.nblkcols else 1
    rq, cq = _pad_counts(grid, role)
    nbr_pad = -(-matrix.nblkrows // rq) * rq
    nbc_pad = -(-matrix.nblkcols // cq) * cq
    home = grid.home()
    grid4 = torch.zeros((nbr_pad, nbc_pad, bm, bn), dtype=matrix.dtype, device=home)
    rows, cols = matrix.entry_coords()
    for b_id, bb in enumerate(matrix.bins):
        sel = np.nonzero(matrix.ent_bin == b_id)[0]
        if not len(sel):
            continue
        blks = bb.data[to_index(matrix.ent_slot[sel], bb.data.device)].to(home)
        r_s, c_s = to_index(rows[sel], home), to_index(cols[sel], home)
        bmb, bnb = bb.shape
        grid4[r_s, c_s, :bmb, :bnb] = blks
        if matrix.matrix_type != "N":
            off = (rows[sel] != cols[sel])
            if off.any():
                offi = to_index(np.nonzero(off)[0], home)
                tb = blks[offi].transpose(1, 2)
                if matrix.matrix_type == "A":
                    tb = -tb
                elif matrix.matrix_type == "H":
                    tb = tb.conj()
                grid4[c_s[offi], r_s[offi], :bnb, :bmb] = tb
    canvas = grid4.permute(0, 2, 1, 3).reshape(nbr_pad * bm, nbc_pad * bn)
    nbytes = canvas.numel() * canvas.element_size()
    stats.record_comm("host2dev", 1, nbytes)
    _trace.annotate(role=role, nbytes=int(nbytes), shape=list(canvas.shape))
    return DistMatrix(data=canvas, row_blk_sizes=matrix.row_blk_sizes.copy(),
                      col_blk_sizes=matrix.col_blk_sizes.copy(), bm=bm, bn=bn,
                      nbr_pad=nbr_pad, nbc_pad=nbc_pad, mesh=grid, role=role,
                      name=name or matrix.name, dtype=matrix.dtype)


def collect(dm: DistMatrix, drop_zero_blocks: bool = True) -> BlockSparseMatrix:
    """Carve the distributed canvas back into a block-sparse matrix on
    the grid's home device, against the original blocking."""
    from dbcsr_tpu_torch.parallel.sparse_dist import adopt_panels

    nbr, nbc = dm.nblkrows, dm.nblkcols
    grid = (dm.data.reshape(dm.nbr_pad, dm.bm, dm.nbc_pad, dm.bn)
            .permute(0, 2, 1, 3)[:nbr, :nbc])
    if drop_zero_blocks:
        # padding beyond each block's true extent is zero by
        # construction, so the padded test is exact
        mask = (grid.reshape(nbr, nbc, -1) != 0).any(dim=2).cpu().numpy()
    else:
        mask = np.ones((nbr, nbc), bool)
    rows, cols = np.nonzero(mask)
    keys = (rows * nbc + cols).astype(np.int64)  # row-major: already sorted
    out = BlockSparseMatrix(dm.name, dm.row_blk_sizes, dm.col_blk_sizes, dm.dtype,
                            device=dm.data.device)
    from dbcsr_tpu_torch.core.matrix import to_index

    blocks = grid[to_index(rows, dm.data.device), to_index(cols, dm.data.device)]
    return adopt_panels(out, keys, blocks)


def replicate(matrix: BlockSparseMatrix, mesh: Grid, name: Optional[str] = None,
              mode: str = "full") -> DistMatrix:
    """Replicate a matrix onto the grid (ref `dbcsr_replicate_all`,
    `dbcsr_transformations.F:108`): "full" onto every image
    (dbcsr_repl_full), "row" across grid rows with columns over 'pc'
    (dbcsr_repl_row), "col" the transpose (dbcsr_repl_col)."""
    try:
        role = {"full": "R", "row": "Rrow", "col": "Rcol"}[mode]
    except KeyError:
        raise ValueError(f"unknown replication mode {mode!r}") from None
    return distribute(matrix, mesh, role=role, name=name)


def multiply_distributed(alpha, a: DistMatrix, b: DistMatrix, beta=0.0,
                         c: Optional[DistMatrix] = None) -> DistMatrix:
    """C = alpha*A@B + beta*C on the grid (Cannon + 2.5D layer sum)."""
    if a.mesh is not b.mesh:
        raise ValueError("operands on different grids")
    if a.role != "A" or b.role != "B":
        raise ValueError("operand roles must be A and B (use distribute(..., role=))")
    if a.bn != b.bm or a.nbc_pad != b.nbr_pad:
        raise ValueError("inner paddings incompatible (blockings differ?)")
    prod = cannon_multiply_dense(a.mesh, a.data, b.data)
    data = alpha * prod
    if c is not None and beta != 0.0:
        data = data + beta * c.data.to(prod.device)
    return DistMatrix(data=data, row_blk_sizes=a.row_blk_sizes.copy(),
                      col_blk_sizes=b.col_blk_sizes.copy(), bm=a.bm, bn=b.bn,
                      nbr_pad=a.nbr_pad, nbc_pad=b.nbc_pad, mesh=a.mesh, role="C",
                      name=f"{a.name}*{b.name}", dtype=a.dtype)
