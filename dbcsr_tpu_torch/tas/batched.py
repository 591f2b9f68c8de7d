"""TAS batched-MM state machine: the counterpart of
`dbcsr_tpu/tas/batched.py`.

Ref the batched multiply state machine in `dbcsr_tas_mm.F:1595-1692`
(`dbcsr_tas_batched_mm_init/finalize`, with states NOT_BATCHED /
BATCHED_NOCHANGE / BATCHED_CHANGED): repeated TAS multiplies into one C
keep their split decision and defer the final filter until the batch
finalizes.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.ops.operations import filter_matrix
from dbcsr_tpu_torch.tas.base import TASMatrix


def _matrix(x: Union[TASMatrix, BlockSparseMatrix]) -> BlockSparseMatrix:
    return x.matrix if isinstance(x, TASMatrix) else x


def batched_mm_init(
    matrix_c: Union[TASMatrix, BlockSparseMatrix], nsplit: Optional[int] = None
) -> None:
    """Enter batched-MM mode on C (ref `dbcsr_tas_batched_mm_init`).  An
    ``nsplit`` given here is the caller's: the between-batch
    re-optimization never overrides it (only chosen splits float)."""
    m = _matrix(matrix_c)
    if getattr(m, "_tas_batched_state", None) is not None:
        raise RuntimeError("matrix already in a batched TAS multiply")
    m._tas_batched_state = {"filter_eps": None, "nsplit": nsplit,
                            "nsplit_explicit": nsplit is not None}


def batched_mm_finalize(matrix_c: Union[TASMatrix, BlockSparseMatrix]) -> None:
    """Leave batched-MM mode; apply the deferred filter once
    (ref `dbcsr_tas_batched_mm_finalize`)."""
    m = _matrix(matrix_c)
    state = getattr(m, "_tas_batched_state", None)
    if state is None:
        raise RuntimeError("matrix not in a batched TAS multiply")
    m._tas_batched_state = None
    eps = state.get("filter_eps")
    if eps is not None:
        filter_matrix(m, eps)


@contextlib.contextmanager
def batched_mm(
    matrix_c: Union[TASMatrix, BlockSparseMatrix], nsplit: Optional[int] = None
) -> Iterator[None]:
    """Context-manager form of the batched-MM state machine."""
    batched_mm_init(matrix_c, nsplit=nsplit)
    try:
        yield
    finally:
        batched_mm_finalize(matrix_c)
