"""State carried across packages: a matrix or a tensor as a plain dict
of numpy arrays, so that another implementation (the JAX package, in
the tests) and this one can compute on identical operands.

The state holds ``row_blk_sizes``, ``col_blk_sizes``, ``matrix_type``,
``dtype`` (the reference enum: 1 f32, 3 f64, 9 bf16), ``keys``,
``ent_bin``, ``ent_slot`` and ``bins``, a list of ``(bm, bn, data)`` with
``data`` the bin's first ``count`` blocks (a producer with padded bins
slices them off).  bf16 data may come as float32 or as a numpy bfloat16
extension array; both convert exactly.  A symmetric kind ("S", "A"; a
real "H" becomes "S") carries its stored upper triangle only.

A tensor's state holds ``blk_sizes`` (one array per dimension),
``row_dims`` and ``col_dims`` (the nd->2d mapping), ``dtype`` (the enum),
``indices``, an (N, ndim) int64 array of block multi-indices, and
``blocks``, the N rank-d blocks in the same order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dbcsr_tpu_torch.core.kinds import enum_of
from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY, BlockSparseMatrix, _Bin, to_device, to_host
from dbcsr_tpu_torch.device import DeviceLike
from dbcsr_tpu_torch.tensor.types import BlockSparseTensor


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
    # copies: the matrix's index arrays are never written into, and must
    # not alias the caller's (the pattern fingerprint is memoized on them)
    keys = np.array(state["keys"], np.int64)
    ent_bin = np.array(state["ent_bin"], np.int32)
    ent_slot = np.array(state["ent_slot"], np.int32)
    if not (len(keys) == len(ent_bin) == len(ent_slot)):
        raise ValueError("keys/ent_bin/ent_slot lengths differ")
    if len(keys) and not np.all(np.diff(keys) > 0):
        raise ValueError("keys must be sorted and unique")
    if m.matrix_type != NO_SYMMETRY and np.any(keys // m.nblkcols > keys % m.nblkcols):
        raise ValueError(f"a matrix of kind {m.matrix_type!r} stores only "
                         f"its upper triangle (row <= col)")
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


def tensor_from_numpy_state(state: dict, device: Optional[DeviceLike] = None,
                            name: str = "T") -> BlockSparseTensor:
    """Build a finalized tensor on ``device`` from a numpy state dict: the
    blocks of each nd shape are laid out in the mapping's matrix order
    on the host and staged as one batch."""
    t = BlockSparseTensor(name, state["blk_sizes"], state["row_dims"], state["col_dims"],
                          int(state["dtype"]), device=device)
    idx = np.asarray(state["indices"], np.int64).reshape(-1, t.ndim)
    blocks = state["blocks"]
    if len(blocks) != len(idx):
        raise ValueError(f"{len(blocks)} blocks for {len(idx)} indices")
    if len(idx) == 0:
        return t.finalize()
    nblks = t.nblks_per_dim
    if idx.min() < 0 or np.any(idx >= np.asarray(nblks)):
        raise IndexError("block indices out of range")
    shp = np.stack([t.blk_sizes[d][idx[:, d]] for d in range(t.ndim)], axis=1)
    perm = t.row_dims + t.col_dims
    rows = np.zeros(len(idx), np.int64)
    cols = np.zeros(len(idx), np.int64)
    for d in t.row_dims:
        rows = rows * nblks[d] + idx[:, d]
    for d in t.col_dims:
        cols = cols * nblks[d] + idx[:, d]
    _, group = np.unique(shp, axis=0, return_inverse=True)
    for g in range(int(group.max()) + 1):
        sel = np.nonzero(group.reshape(-1) == g)[0]
        s = shp[sel[0]]
        arr = np.stack([np.asarray(blocks[i]) for i in sel])
        if arr.shape[1:] != tuple(int(x) for x in s):
            raise ValueError(f"block of shape {arr.shape[1:]} where the blocking "
                             f"gives {tuple(int(x) for x in s)}")
        if arr.dtype.kind != "f" or arr.dtype.itemsize < 4:
            arr = arr.astype(np.float32)  # numpy bfloat16 extension type
        mat = arr.transpose((0,) + tuple(1 + d for d in perm)).reshape(
            len(sel), int(np.prod([s[d] for d in t.row_dims], dtype=np.int64)),
            int(np.prod([s[d] for d in t.col_dims], dtype=np.int64)))
        t.matrix.put_blocks(rows[sel], cols[sel], mat)
    return t.finalize()


def tensor_to_numpy_state(t: BlockSparseTensor) -> dict:
    """The numpy state dict of a finalized tensor, blocks in the matrix's
    key order (bf16 data as float32)."""
    if not t.matrix.valid:
        raise RuntimeError("finalize() before exporting")
    return {
        "blk_sizes": [s.copy() for s in t.blk_sizes],
        "row_dims": tuple(t.row_dims),
        "col_dims": tuple(t.col_dims),
        "dtype": enum_of(t.dtype),
        "indices": t.entry_multi_coords(),
        "blocks": [blk for _, blk in t.iterate_blocks()],
    }
