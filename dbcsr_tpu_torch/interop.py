"""State carried across packages: a matrix as a plain dict of numpy
arrays, so that another implementation (the JAX package, in the tests)
and this one can compute on identical operands.

The state holds ``row_blk_sizes``, ``col_blk_sizes``, ``matrix_type``,
``dtype`` (the reference enum: 1 f32, 3 f64, 9 bf16), ``keys``,
``ent_bin``, ``ent_slot`` and ``bins``, a list of ``(bm, bn, data)`` with
``data`` the bin's first ``count`` blocks (a producer with padded bins
slices them off).  bf16 data may come as float32 or as a numpy bfloat16
extension array; both convert exactly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dbcsr_tpu_torch.core.kinds import enum_of
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix, _Bin, to_device, to_host
from dbcsr_tpu_torch.device import DeviceLike


def matrix_from_numpy_state(state: dict, device: Optional[DeviceLike] = None,
                            name: str = "M") -> BlockSparseMatrix:
    """Build a finalized matrix on ``device`` from a numpy state dict."""
    m = BlockSparseMatrix(name, state["row_blk_sizes"], state["col_blk_sizes"],
                          int(state["dtype"]), matrix_type=state.get("matrix_type", "N"),
                          device=device)
    bins = []
    for bm, bn, data in state["bins"]:
        data = np.asarray(data)
        if data.dtype.kind != "f" or data.dtype.itemsize < 4:
            data = data.astype(np.float32)  # numpy bfloat16 extension type
        if data.shape[1:] != (int(bm), int(bn)):
            raise ValueError(f"bin data of shape {data.shape} is not ({bm},{bn}) blocks")
        bins.append(_Bin((int(bm), int(bn)), to_device(data, m.dtype, m.device),
                         data.shape[0]))
    keys = np.asarray(state["keys"], np.int64)
    ent_bin = np.asarray(state["ent_bin"], np.int32)
    ent_slot = np.asarray(state["ent_slot"], np.int32)
    if not (len(keys) == len(ent_bin) == len(ent_slot)):
        raise ValueError("keys/ent_bin/ent_slot lengths differ")
    if len(keys) and not np.all(np.diff(keys) > 0):
        raise ValueError("keys must be sorted and unique")
    for b_id, b in enumerate(bins):
        slots = ent_slot[ent_bin == b_id]
        if len(slots) != b.count or (len(slots) and slots.max() >= b.count):
            raise ValueError(f"bin {b_id} holds {b.count} blocks but the index "
                             f"places {len(slots)} there")
    shapes = [b.shape for b in bins]
    m.set_structure_from_device(keys, bins, binning=(ent_bin, ent_slot, shapes))
    return m


def matrix_to_numpy_state(m: BlockSparseMatrix) -> dict:
    """The numpy state dict of a finalized matrix (bf16 data as float32)."""
    if not m.valid:
        raise RuntimeError("finalize() before exporting")
    return {
        "row_blk_sizes": m.row_blk_sizes.copy(),
        "col_blk_sizes": m.col_blk_sizes.copy(),
        "matrix_type": m.matrix_type,
        "dtype": enum_of(m.dtype),
        "keys": m.keys.copy(),
        "ent_bin": m.ent_bin.copy(),
        "ent_slot": m.ent_slot.copy(),
        "bins": [(b.shape[0], b.shape[1], to_host(b.data[: b.count])) for b in m.bins],
    }
