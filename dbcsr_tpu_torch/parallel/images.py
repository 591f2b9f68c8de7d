"""Image distributions: virtual process-grid axes.

A copy of `dbcsr_tpu/parallel/images.py` (pure NumPy).  Re-design of the reference's image distribution machinery
(`dbcsr_imagedistribution_type`, `dbcsr_types.F:188-223`, created by
`dbcsr_create_image_dist`, `dbcsr_mm_dist_operations.F:58`): when a
matrix dimension must be dealt over more positions than the physical
grid axis offers, the axis is *virtualized* — each physical position
carries `multiplicity` images, and blocks are decimated cyclically over
the `nimages = nphysical * multiplicity` virtual positions.

On the grid the standing use is the k dimension of the sparse Cannon
multiply (`parallel/sparse_dist.py`): k blocks are dealt over
``kl * s`` virtual columns — multiplicity ``kl`` per physical grid
column — and the extra image index is exactly the 2.5D layer, so the
"image reduction" of the reference (`dbcsr_mm_3d.F:1037`) is the sum
over the 'kl' axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageDistribution:
    """Cyclic decimation of a block axis over a virtualized grid axis."""

    nphysical: int  # physical grid-axis size
    multiplicity: int  # images per physical position

    def __post_init__(self):
        if self.nphysical < 1 or self.multiplicity < 1:
            raise ValueError("nphysical and multiplicity must be >= 1")

    @property
    def nimages(self) -> int:
        return self.nphysical * self.multiplicity

    def image_of(self, blk):
        """Block index -> virtual position (cyclic decimation)."""
        return np.asarray(blk) % self.nimages

    def split(self, blk):
        """Block index -> (local image a.k.a. layer, physical position)."""
        v = self.image_of(blk)
        return v // self.nphysical, v % self.nphysical

    def blocks_of_image(self, image: int, nblocks: int) -> np.ndarray:
        """All block indices decimated onto one virtual position."""
        return np.arange(image, nblocks, self.nimages)


def make_image_dist(nphysical_a: int, nphysical_b: int) -> "ImageDistribution":
    """Match two incompatible physical axis sizes by virtualizing to
    their least common multiple (the reference's row/col image pairing,
    `dbcsr_mm_dist_operations.F:58`): returns the image distribution
    for an axis of size ``nphysical_a`` whose images line up with a
    ``nphysical_b``-sized partner axis."""
    lcm = int(np.lcm(nphysical_a, nphysical_b))
    return ImageDistribution(nphysical_a, lcm // nphysical_a)
