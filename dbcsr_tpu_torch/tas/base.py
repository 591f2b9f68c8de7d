"""TAS matrix type: the counterpart of `dbcsr_tpu/tas/base.py`.

Ref `dbcsr_tas_base.F` / `dbcsr_tas_types.F`: a thin wrapper around the
2D block-sparse matrix carrying split metadata.  The reference needs
pure-function global distributions to avoid O(N) index arrays
(`dbcsr_tas_global.F`); here the host index is already compact NumPy,
so the wrapper only tracks which dimension is long and how it is
grouped.
"""

from __future__ import annotations

from typing import Optional

import torch

from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.device import DeviceLike


def _groups(nblk: int, nsplit: int) -> list:
    """Contiguous ranges of ``nblk`` block indices in ``nsplit`` groups
    of ceil(nblk / nsplit)."""
    per = -(-nblk // nsplit)
    return [(g * per, min((g + 1) * per, nblk)) for g in range(nsplit) if g * per < nblk]


class TASMatrix:
    """A (possibly tall-and-skinny) block-sparse matrix with split info."""

    def __init__(self, matrix: BlockSparseMatrix, nsplit: Optional[int] = None):
        self.matrix = matrix
        self.nsplit = nsplit  # None = decide at multiply time

    @classmethod
    def create(cls, name: str, row_blk_sizes, col_blk_sizes, dtype=torch.float64,
               nsplit: Optional[int] = None,
               device: Optional[DeviceLike] = None) -> "TASMatrix":
        """An empty TAS matrix on ``device`` (the card unless the CPU is
        asked for; ref `dbcsr_tas_create`)."""
        return cls(BlockSparseMatrix(name, row_blk_sizes, col_blk_sizes, dtype,
                                     device=device), nsplit)

    # passthrough API (ref dbcsr_tas_create/put_block/iterate)
    @property
    def nblkrows(self) -> int:
        return self.matrix.nblkrows

    @property
    def nblkcols(self) -> int:
        return self.matrix.nblkcols

    @property
    def dtype(self):
        return self.matrix.dtype

    def put_block(self, row: int, col: int, block, summation: bool = False) -> None:
        self.matrix.put_block(row, col, block, summation)

    def get_block(self, row: int, col: int):
        return self.matrix.get_block(row, col)

    def finalize(self) -> "TASMatrix":
        self.matrix.finalize()
        return self

    def iterate_blocks(self):
        return self.matrix.iterate_blocks()

    @property
    def long_dim(self) -> str:
        """'rows' if taller than wide, else 'cols'."""
        return "rows" if self.matrix.nfullrows >= self.matrix.nfullcols else "cols"

    def row_groups(self, nsplit: int) -> list:
        """Contiguous block-row group ranges for an nsplit split."""
        return _groups(self.nblkrows, nsplit)

    def col_groups(self, nsplit: int) -> list:
        return _groups(self.nblkcols, nsplit)

    def __repr__(self) -> str:
        return f"TASMatrix({self.matrix!r}, nsplit={self.nsplit})"
