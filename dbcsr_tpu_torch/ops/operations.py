"""Matrix operations: `compress`, the one op the stack multiply needs
(its ``filter_eps`` pass).  Counterpart of `dbcsr_tpu/ops/operations.py`
(ref `src/ops/dbcsr_operations.F`).
"""

from __future__ import annotations

import numpy as np
import torch

from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix, _Bin


def compress(matrix: BlockSparseMatrix, keep: np.ndarray) -> BlockSparseMatrix:
    """Drop the entries where ``keep`` is False, rebuilding the bins by
    one device gather each (sorted slots keep key order within a bin)."""
    if not matrix.valid:
        raise RuntimeError(f"matrix {matrix.name!r} needs finalize() first")
    if keep.all():
        return matrix
    ent_bin = matrix.ent_bin[keep]
    ent_slot = matrix.ent_slot[keep]
    bins = []
    for b_id, b in enumerate(matrix.bins):
        slots = np.sort(ent_slot[ent_bin == b_id]).astype(np.int64)
        if len(slots):
            bins.append(_Bin(b.shape, b.data[torch.from_numpy(slots).to(b.data.device)],
                             len(slots)))
    matrix.set_structure_from_device(matrix.keys[keep], bins)
    return matrix
