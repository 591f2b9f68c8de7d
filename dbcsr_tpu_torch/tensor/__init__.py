"""Tensor layer: n-rank block-sparse tensor contraction, the counterpart
of `dbcsr_tpu/tensor/`.

Re-design of `src/tensors`: a rank-2..4 block-sparse tensor is stored
as a block-sparse matrix through an nd->2d mapping (which tensor dims
become matrix rows vs cols, `dbcsr_tensor_types.F:119-136`);
`contract` aligns indices, remaps operands to compatible matrix
layouts, runs the TAS multiply, and maps back
(`dbcsr_tensor.F:418,1162-1183`).  Tensors live on the card unless the
caller asks for the CPU (``create_tensor(..., device="cpu")``).
"""

from dbcsr_tpu_torch.tensor.types import (
    BlockSparseTensor,
    copy_matrix_to_tensor,
    copy_tensor_to_matrix,
    create_tensor,
    split_blocks,
)
from dbcsr_tpu_torch.tensor.contract import (
    contract,
    contract_test,
    tensor_copy,
    remap,
    restrict_tensor,
)
from dbcsr_tpu_torch.tensor.batched import (
    batched_contract_init,
    batched_contract_finalize,
    batched_contraction,
)
