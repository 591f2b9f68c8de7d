"""Block distributions (ref `dbcsr_distribution_type`,
`src/core/dbcsr_types.F:143-182`).  Counterpart of
`dbcsr_tpu/core/dist.py`: the single-device engine uses a 1x1 grid on
which every block is local; a grid engine's product carries its
`parallel.mesh.Grid` in ``ProcessGrid.mesh``.  The 1-D binning helpers
and the offset converters are copies of the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """2D grid of workers; the single-card engine uses 1x1.  ``mesh`` is
    the `parallel.mesh.Grid` a grid engine computed on, if any."""

    nprows: int = 1
    npcols: int = 1
    mesh: Optional[object] = dataclasses.field(default=None, compare=False)

    @property
    def nprocs(self) -> int:
        return self.nprows * self.npcols


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

    def get_info(self) -> dict:
        """Distribution summary (ref `dbcsr_distribution_get`,
        `dbcsr_api.F:226`)."""
        return {"nblkrows": self.nblkrows, "nblkcols": self.nblkcols,
                "nprows": self.grid.nprows, "npcols": self.grid.npcols,
                "row_dist": self.row_dist.copy(), "col_dist": self.col_dist.copy()}

    def checksum(self) -> int:
        """Content hash of the maps, the JAX package's (ref
        `dbcsr_dist_util.F:57`): the lengths and grid first, so a 2x3 and
        a 3x2 blocking with the same concatenated maps differ."""
        h = hashlib.sha1(np.int64([self.nblkrows, self.nblkcols, self.grid.nprows,
                                   self.grid.npcols]).tobytes())
        h.update(self.row_dist.tobytes())
        h.update(self.col_dist.tobytes())
        return int.from_bytes(h.digest()[:8], "little")

    def fingerprint(self) -> int:
        """Memoized `checksum()` (the maps are not written once the
        distribution is attached to a matrix); keys the grid engines'
        plan cache."""
        fp = getattr(self, "_fp", None)
        if fp is None:
            fp = self._fp = self.checksum()
        return fp

    def transposed(self) -> "Distribution":
        """Ref `dbcsr_transpose_distribution`."""
        grid = ProcessGrid(self.grid.npcols, self.grid.nprows, self.grid.mesh)
        return Distribution(self.col_dist, self.row_dist, grid)

    def stored_coordinates(self, row: int, col: int):
        """Owning (prow, pcol) of a block (ref
        `dbcsr_get_stored_coordinates`, `dbcsr_dist_operations.F`)."""
        return int(self.row_dist[row]), int(self.col_dist[col])

    @staticmethod
    def trivial(nblkrows: int, nblkcols: int) -> "Distribution":
        return Distribution(np.zeros(nblkrows, np.int32),
                            np.zeros(nblkcols, np.int32), ProcessGrid())


def random_dist(nblks: int, nbins: int, seed: int = 0) -> np.ndarray:
    """Ref `dbcsr_random_dist` (tests/dbcsr_performance_multiply.F)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, nbins, size=nblks).astype(np.int32)


def cyclic_dist(nblks: int, nbins: int) -> np.ndarray:
    return (np.arange(nblks) % nbins).astype(np.int32)


def dist_bin(nelements: int, nbins: int, element_sizes: Optional[np.ndarray] = None,
             rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Load-aware 1-D binning (ref `dbcsr_dist_bin`,
    `dbcsr_dist_operations.F:705-745`): with sizes, each element in order
    goes to the currently least-loaded bin (a min-heap, ties to the lower
    bin); without, uniform random."""
    if element_sizes is None:
        rng = rng or np.random.default_rng()
        return rng.integers(0, nbins, nelements).astype(np.int32)
    element_sizes = np.asarray(element_sizes)
    if len(element_sizes) != nelements:
        raise ValueError("element_sizes length != nelements")
    heap = [(0, b) for b in range(nbins)]
    heapq.heapify(heap)
    out = np.empty(nelements, np.int32)
    for i in range(nelements):
        load, b = heapq.heappop(heap)
        out[i] = b
        heapq.heappush(heap, (load + int(element_sizes[i]), b))
    return out


def convert_sizes_to_offsets(sizes) -> np.ndarray:
    """Block sizes -> start offsets, length n + 1 with the total last
    (ref `convert_sizes_to_offsets`, `src/dist/dbcsr_dist_util.F:140`)."""
    sizes = np.ascontiguousarray(sizes, np.int64)
    out = np.empty(len(sizes) + 1, np.int64)
    out[0] = 0
    np.cumsum(sizes, out=out[1:])
    return out


def convert_offsets_to_sizes(offsets) -> np.ndarray:
    """Start offsets (length n + 1) -> block sizes
    (ref `convert_offsets_to_sizes`, `src/dist/dbcsr_dist_util.F:180`)."""
    return np.diff(np.ascontiguousarray(offsets, np.int64))
