"""TAS (tall-and-skinny) layer, the counterpart of `dbcsr_tpu/tas/`.

Re-design of `src/tas`: matrices with one dimension much larger than
the other are processed as a split stack of ordinary block-sparse
multiplies -- split the long dimension into groups and multiply per
group (`dbcsr_tas_mm.F:10-17,79`).  On one device the groups bound the
working set of each multiply; on a process grid (``mesh=``) they run
as per-group Cannons of the port's `parallel/`.
"""

from dbcsr_tpu_torch.tas.base import TASMatrix
from dbcsr_tpu_torch.tas.split import (
    choose_nsplit,
    choose_nsplit_traffic,
    estimate_split_factor,
    estimate_split_traffic,
)
from dbcsr_tpu_torch.tas.mm import tas_multiply
from dbcsr_tpu_torch.tas.batched import batched_mm, batched_mm_init, batched_mm_finalize
