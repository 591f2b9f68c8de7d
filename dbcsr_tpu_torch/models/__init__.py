"""The linear-scaling DFT iterations built on the engine.

Counterpart of `dbcsr_tpu/models/`: McWeeny purification (`purify`, also
as one step on a process grid, dense or block-sparse panels), the
Newton–Schulz sign iteration (`sign`) and the coupled Newton–Schulz
inverse square root (`invsqrt`), each a chain of filtered same-pattern
multiplies with scale, add, trace, norm and diagonal operations between
them.
"""

from dbcsr_tpu_torch.models.invsqrt import invsqrt_iteration, invsqrt_step
from dbcsr_tpu_torch.models.purify import (
    make_test_density,
    mcweeny_purify,
    mcweeny_step,
    mcweeny_step_distributed,
    mcweeny_step_sparse_distributed,
)
from dbcsr_tpu_torch.models.sign import sign_iteration, sign_step

__all__ = ["invsqrt_iteration", "invsqrt_step", "make_test_density", "mcweeny_purify",
           "mcweeny_step", "mcweeny_step_distributed", "mcweeny_step_sparse_distributed",
           "sign_iteration", "sign_step"]
