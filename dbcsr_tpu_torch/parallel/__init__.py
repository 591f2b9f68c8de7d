"""Distributed layer: 2D/2.5D process grids (the counterpart of
`dbcsr_tpu/parallel/`).

The reference's MPI machinery (SURVEY §2.3/2.4) in two layers:

* a grid of images in one process (`mesh.Grid`, the counterpart of the
  JAX package's single-controller ('kl', 'pr', 'pc') mesh): each image
  is a (rank, device) slot, and one process may put every image on one
  card;
* a multi-process world over `torch.distributed` with the gloo backend
  (`multihost`, the counterpart of `jax.distributed`), whose ranks own
  images and exchange panels host-staged.

Cannon's metronome (`dbcsr_mm_cannon.F:1345`) is `overlap.run_ticks`;
the 2.5D k layers (`dbcsr_mm_3d.F`, NUM_LAYERS_3D) are the 'kl' axis,
summed in layer order; the per-tick stacks run on the acc layer's
kernels.
"""

from dbcsr_tpu_torch.parallel.mesh import Grid, grid_shape, make_grid, optimize_grid
from dbcsr_tpu_torch.parallel.cannon import cannon_multiply_dense
from dbcsr_tpu_torch.parallel.dist_matrix import (
    DistMatrix,
    collect,
    distribute,
    multiply_distributed,
    replicate,
)
from dbcsr_tpu_torch.parallel.sparse_dist import (
    sparse_multiply_distributed,
    tas_grouped_multiply,
)
from dbcsr_tpu_torch.parallel.images import ImageDistribution, make_image_dist
from dbcsr_tpu_torch.parallel.multihost import (
    init_multihost,
    is_coordinator,
    make_multihost_grid,
    process_count,
    process_id,
    shutdown_multihost,
)
