"""Batched tensor contraction: the counterpart of
`dbcsr_tpu/tensor/batched.py`.

Ref `dbcsr_t_batched_contract_init/finalize` + the batched storage
machinery (`dbcsr_tensor.F:1964-2186`): a sequence of contractions into
the same C (typically chunked over an index range with the contract
``bounds`` arguments) runs with filtering deferred and split choices
reused, then one finalize applies the filter.  The reference also
re-optimizes the process grid between batches; on one device that
corresponds to re-choosing the TAS ``nsplit``, which the state caches
here.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

from dbcsr_tpu_torch.ops.operations import filter_matrix
from dbcsr_tpu_torch.tas.batched import batched_mm_finalize, batched_mm_init
from dbcsr_tpu_torch.tensor.types import BlockSparseTensor


def batched_contract_init(
    tensor_c: BlockSparseTensor, nsplit: Optional[int] = None
) -> None:
    """Enter batched mode on C (ref `dbcsr_t_batched_contract_init`)."""
    if getattr(tensor_c, "_batched_state", None) is not None:
        raise RuntimeError("tensor already in a batched contraction")
    tensor_c._batched_state = {"filter_eps": None}
    # the TAS-level state machine on C's matrix caches the split
    # decision across the whole batch (and is what tas_multiply reads)
    batched_mm_init(tensor_c.matrix, nsplit=nsplit)


def batched_contract_finalize(tensor_c: BlockSparseTensor) -> None:
    """Leave batched mode: apply the deferred filter once
    (ref `dbcsr_t_batched_contract_finalize`)."""
    state = getattr(tensor_c, "_batched_state", None)
    if state is None:
        raise RuntimeError("tensor not in a batched contraction")
    tensor_c._batched_state = None
    batched_mm_finalize(tensor_c.matrix)
    eps = state.get("filter_eps")
    if eps is not None:
        filter_matrix(tensor_c.matrix, eps)


@contextlib.contextmanager
def batched_contraction(
    tensor_c: BlockSparseTensor, nsplit: Optional[int] = None
) -> Iterator[BlockSparseTensor]:
    """Context-manager form: ``with batched_contraction(c): contract(...)``."""
    batched_contract_init(tensor_c, nsplit=nsplit)
    try:
        yield tensor_c
    finally:
        batched_contract_finalize(tensor_c)
