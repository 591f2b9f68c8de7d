"""Block distributions (ref `dbcsr_distribution_type`,
`src/core/dbcsr_types.F:143-182`).  Counterpart of
`dbcsr_tpu/core/dist.py`, cut to the single-card engine: one 1x1 grid
on which every block is local.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """2D grid of workers; the single-card engine uses 1x1."""

    nprows: int = 1
    npcols: int = 1


class Distribution:
    """Maps each block row/col to a grid row/col
    (ref `dbcsr_distribution_new`, `src/dist/dbcsr_dist_methods.F:49`)."""

    def __init__(self, row_dist, col_dist, grid: ProcessGrid | None = None):
        self.row_dist = np.ascontiguousarray(row_dist, dtype=np.int32)
        self.col_dist = np.ascontiguousarray(col_dist, dtype=np.int32)
        self.grid = grid or ProcessGrid()
        if self.row_dist.size and self.row_dist.max() >= self.grid.nprows:
            raise ValueError("row_dist entry exceeds grid rows")
        if self.col_dist.size and self.col_dist.max() >= self.grid.npcols:
            raise ValueError("col_dist entry exceeds grid cols")

    @property
    def nblkrows(self) -> int:
        return len(self.row_dist)

    @property
    def nblkcols(self) -> int:
        return len(self.col_dist)

    def transposed(self) -> "Distribution":
        """Ref `dbcsr_transpose_distribution`."""
        grid = ProcessGrid(self.grid.npcols, self.grid.nprows)
        return Distribution(self.col_dist, self.row_dist, grid)

    @staticmethod
    def trivial(nblkrows: int, nblkcols: int) -> "Distribution":
        return Distribution(np.zeros(nblkrows, np.int32),
                            np.zeros(nblkcols, np.int32), ProcessGrid())
