"""Block-sparse tensor type and the nd->2d mapping: the counterpart of
`dbcsr_tpu/tensor/types.py`.

Ref `dbcsr_tensor_types.F:119-136` (`nd_to_2d_mapping`): tensor dims
are partitioned into (row_dims, col_dims); the tensor is stored as a
block-sparse matrix whose block rows enumerate the mixed-radix product
of the row dims' blocks (C-order) and likewise for columns.  A tensor
block of shape (s_0,...,s_{d-1}) is stored as the matrix block
transpose(row_dims + col_dims).reshape(prod_rows, prod_cols).

A tensor lives where its matrix does: on the card unless the caller asks
for the CPU (``device=``).  Blocks come and go as host numpy arrays, as
in the JAX package.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dbcsr_tpu_torch.core.kinds import host_dtype, name_of
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.device import DeviceLike
from dbcsr_tpu_torch.ops import operations as ops
from dbcsr_tpu_torch.ops.test_methods import checksum as _checksum
from dbcsr_tpu_torch.ops.transformations import desymmetrize


def _mixed_radix_sizes(blk_sizes: List[np.ndarray], dims: Sequence[int]) -> np.ndarray:
    """Matrix block sizes for the product of `dims` (C-order)."""
    if not dims:
        return np.asarray([1], np.int32)
    out = np.asarray([1], np.int64)
    for d in dims:
        out = np.multiply.outer(out, blk_sizes[d].astype(np.int64)).reshape(-1)
    return out.astype(np.int32)


class BlockSparseTensor:
    """A rank-d block-sparse tensor stored as a matrix."""

    def __init__(
        self,
        name: str,
        blk_sizes: List[np.ndarray],
        row_dims: Sequence[int],
        col_dims: Sequence[int],
        dtype=torch.float64,
        device: Optional[DeviceLike] = None,
    ):
        self.name = name
        self.blk_sizes = [np.ascontiguousarray(s, np.int32) for s in blk_sizes]
        self.ndim = len(self.blk_sizes)
        self.row_dims = tuple(row_dims)
        self.col_dims = tuple(col_dims)
        if sorted(self.row_dims + self.col_dims) != list(range(self.ndim)):
            raise ValueError("row_dims + col_dims must partition the tensor dims")
        self.matrix = BlockSparseMatrix(
            name,
            _mixed_radix_sizes(self.blk_sizes, self.row_dims),
            _mixed_radix_sizes(self.blk_sizes, self.col_dims),
            dtype,
            device=device,
        )
        self.dtype = self.matrix.dtype

    @property
    def device(self) -> torch.device:
        return self.matrix.device

    # ------------------------------------------------------------- indexing
    @property
    def nblks_per_dim(self) -> Tuple[int, ...]:
        return tuple(len(s) for s in self.blk_sizes)

    def _flat(self, idx: Sequence[int], dims: Sequence[int]) -> int:
        f = 0
        for d in dims:
            f = f * len(self.blk_sizes[d]) + idx[d]
        return f

    def _unflat(self, flat: int, dims: Sequence[int]) -> List[int]:
        out = []
        for d in reversed(dims):
            out.append(flat % len(self.blk_sizes[d]))
            flat //= len(self.blk_sizes[d])
        return list(reversed(out))

    def block_coords(self, row: int, col: int) -> Tuple[int, ...]:
        """Matrix (row, col) -> tensor block multi-index."""
        idx = [0] * self.ndim
        for d, v in zip(self.row_dims, self._unflat(row, self.row_dims)):
            idx[d] = v
        for d, v in zip(self.col_dims, self._unflat(col, self.col_dims)):
            idx[d] = v
        return tuple(idx)

    def block_shape(self, idx: Sequence[int]) -> Tuple[int, ...]:
        return tuple(int(self.blk_sizes[d][idx[d]]) for d in range(self.ndim))

    # --------------------------------------------------------------- blocks
    def put_block(self, idx: Sequence[int], block, summation: bool = False) -> None:
        """Stage a rank-d block (ref `dbcsr_t_put_block`)."""
        block = np.asarray(block)
        if block.shape != self.block_shape(idx):
            raise ValueError(
                f"block {tuple(idx)} has shape {block.shape}, "
                f"expected {self.block_shape(idx)}"
            )
        perm = self.row_dims + self.col_dims
        mat = block.transpose(perm).reshape(
            int(np.prod([block.shape[d] for d in self.row_dims], dtype=np.int64)),
            int(np.prod([block.shape[d] for d in self.col_dims], dtype=np.int64)),
        )
        self.matrix.put_block(
            self._flat(idx, self.row_dims), self._flat(idx, self.col_dims), mat,
            summation=summation,
        )

    def get_block(self, idx: Sequence[int]):
        """Fetch a rank-d block or None (ref `dbcsr_t_get_block`)."""
        mat = self.matrix.get_block(
            self._flat(idx, self.row_dims), self._flat(idx, self.col_dims)
        )
        if mat is None:
            return None
        shape = self.block_shape(idx)
        perm = self.row_dims + self.col_dims
        inv = np.argsort(perm)
        return mat.reshape(tuple(shape[d] for d in perm)).transpose(inv)

    def finalize(self) -> "BlockSparseTensor":
        self.matrix.finalize()
        return self

    def iterate_blocks(self) -> Iterator[Tuple[Tuple[int, ...], np.ndarray]]:
        """Yield (multi-index, rank-d block) (ref `dbcsr_t_iterator`)."""
        perm = self.row_dims + self.col_dims
        inv = np.argsort(perm)
        for r, c, mat in self.matrix.iterate_blocks():
            idx = self.block_coords(r, c)
            shape = self.block_shape(idx)
            yield idx, mat.reshape(tuple(shape[d] for d in perm)).transpose(inv)

    @property
    def nblks(self) -> int:
        return self.matrix.nblks

    def to_dense(self) -> np.ndarray:
        """Densify (test oracle; ref tensor unittest pattern)."""
        full = tuple(int(s.sum()) for s in self.blk_sizes)
        out = np.zeros(full, dtype=host_dtype(self.dtype))
        offs = [np.concatenate([[0], np.cumsum(s)]) for s in self.blk_sizes]
        for idx, blk in self.iterate_blocks():
            sl = tuple(
                slice(offs[d][idx[d]], offs[d][idx[d]] + blk.shape[d])
                for d in range(self.ndim)
            )
            out[sl] = blk
        return out

    def block_indices(self) -> List[Tuple[int, ...]]:
        rows, cols = self.matrix.entry_coords()
        return [self.block_coords(int(r), int(c)) for r, c in zip(rows, cols)]

    def entry_multi_coords(self) -> np.ndarray:
        """(nblks, ndim) int64 array of tensor block multi-indices, in
        matrix key order (vectorized `block_coords`)."""
        rows, cols = self.matrix.entry_coords()
        nd = np.empty((len(rows), self.ndim), np.int64)
        f = rows.copy()
        for d in reversed(self.row_dims):
            n = len(self.blk_sizes[d])
            nd[:, d] = f % n
            f //= n
        f = cols.copy()
        for d in reversed(self.col_dims):
            n = len(self.blk_sizes[d])
            nd[:, d] = f % n
            f //= n
        return nd

    # ----------------------------------------------- api parity (dbcsr_t_*)
    def reserve_blocks(self, indices) -> "BlockSparseTensor":
        """Ensure the listed multi-index blocks exist, zero where absent
        (ref `dbcsr_t_reserve_blocks`)."""
        if np.asarray(indices).size == 0:
            self.matrix.finalize()
            return self
        idxs = np.atleast_2d(np.asarray(indices, np.int64))
        if idxs.shape[1] != self.ndim:
            raise ValueError(f"indices must be (N, {self.ndim})")
        rows = np.array([self._flat(i, self.row_dims) for i in idxs], np.int64)
        cols = np.array([self._flat(i, self.col_dims) for i in idxs], np.int64)
        ops.reserve_blocks(self.matrix, rows, cols)
        return self

    def scale(self, alpha) -> "BlockSparseTensor":
        """Ref `dbcsr_t_scale`."""
        ops.scale(self.matrix, alpha)
        return self

    def set_value(self, alpha) -> "BlockSparseTensor":
        """Set every stored element (ref `dbcsr_t_set`)."""
        ops.set_value(self.matrix, alpha)
        return self

    def clear(self) -> "BlockSparseTensor":
        """Remove all blocks (ref `dbcsr_t_clear`)."""
        ops.clear(self.matrix)
        return self

    def filter(self, eps: float) -> "BlockSparseTensor":
        """Drop blocks below the Frobenius threshold (ref `dbcsr_t_filter`)."""
        ops.filter_matrix(self.matrix, eps)
        return self

    def checksum(self, pos: bool = False) -> float:
        """Ref `dbcsr_t_checksum`."""
        return _checksum(self.matrix, pos=pos)

    def get_num_blocks(self) -> int:
        """Ref `dbcsr_t_get_num_blocks`/`_total` (single-controller:
        local == total)."""
        return self.nblks

    def get_nze(self) -> int:
        """Stored element count (ref `dbcsr_t_get_nze`/`_total`)."""
        return self.matrix.nnz

    def get_stored_coordinates(self, idx: Sequence[int]) -> Tuple[int, int]:
        """Owning (prow, pcol) of a block (ref
        `dbcsr_t_get_stored_coordinates`, which returns the flat rank;
        here the 2d grid position is the process identity); delegates
        to the 2d matrix distribution."""
        return self.matrix.dist.stored_coordinates(
            self._flat(idx, self.row_dims), self._flat(idx, self.col_dims)
        )

    def blk_sizes_of(self, idx: Sequence[int]) -> Tuple[int, ...]:
        """Block dims at a multi-index (ref `dbcsr_t_blk_sizes`)."""
        return self.block_shape(idx)

    def get_info(self) -> dict:
        """Ref `dbcsr_t_get_info`."""
        return {
            "name": self.name,
            "ndim": self.ndim,
            "nblks_per_dim": self.nblks_per_dim,
            "nfull_per_dim": tuple(int(s.sum()) for s in self.blk_sizes),
            "nblks": self.nblks,
            "nze": self.get_nze(),
            "blk_sizes": [s.copy() for s in self.blk_sizes],
            "row_dims": self.row_dims,
            "col_dims": self.col_dims,
            "data_type": name_of(self.dtype),
        }

    def get_mapping_info(self) -> dict:
        """nd<->2d mapping summary (ref `dbcsr_t_get_mapping_info`)."""
        return {
            "ndim_nd": self.ndim,
            "row_dims": self.row_dims,
            "col_dims": self.col_dims,
            "dims_2d": (self.matrix.nblkrows, self.matrix.nblkcols),
        }

    def write_blocks(self, file=None) -> None:
        """Print every stored block (ref `dbcsr_t_write_blocks`)."""
        import sys

        out = file or sys.stdout
        print(self, file=out)
        for idx, blk in self.iterate_blocks():
            print(f" block {tuple(int(i) for i in idx)} shape {blk.shape}:",
                  file=out)
            with np.printoptions(precision=6, suppress=True):
                print(np.array2string(blk, prefix="  "), file=out)

    def write_split_info(self, file=None) -> None:
        """Print the nd->2d mapping (ref `dbcsr_t_write_split_info`)."""
        import sys

        out = file or sys.stdout
        mi = self.get_mapping_info()
        print(f" tensor {self.name!r}: rank {mi['ndim_nd']}, "
              f"row dims {mi['row_dims']} x col dims {mi['col_dims']} -> "
              f"2d grid {mi['dims_2d'][0]} x {mi['dims_2d'][1]}", file=out)

    def __repr__(self) -> str:
        return (
            f"BlockSparseTensor({self.name!r}, rank {self.ndim}, "
            f"nblks/dim {self.nblks_per_dim}, map {self.row_dims}|{self.col_dims})"
        )


def create_tensor(
    name: str,
    blk_sizes: List,
    row_dims: Optional[Sequence[int]] = None,
    col_dims: Optional[Sequence[int]] = None,
    dtype=torch.float64,
    device: Optional[DeviceLike] = None,
) -> BlockSparseTensor:
    """Create a tensor on ``device`` (the card unless the CPU is asked
    for; ref `dbcsr_t_create`).  Default mapping splits dims in half:
    first ceil(d/2) dims -> rows."""
    nd = len(blk_sizes)
    if row_dims is None and col_dims is None:
        half = (nd + 1) // 2
        row_dims, col_dims = tuple(range(half)), tuple(range(half, nd))
    elif row_dims is None:
        row_dims = tuple(d for d in range(nd) if d not in set(col_dims))
    elif col_dims is None:
        col_dims = tuple(d for d in range(nd) if d not in set(row_dims))
    return BlockSparseTensor(name, blk_sizes, row_dims, col_dims, dtype, device)


def split_blocks(tensor: BlockSparseTensor, new_blk_sizes: List,
                 name: Optional[str] = None) -> BlockSparseTensor:
    """Re-block a tensor onto FINER per-dim block sizes — every original
    block boundary must survive in the new blocking (ref
    `dbcsr_t_split_blocks`, `dbcsr_tensor_split.F`).  Data moves
    block-by-block on host: the mixed-radix 2d mapping interleaves dims,
    so this is NOT expressible as a matrix re-blocking."""
    new_sizes = [np.ascontiguousarray(s, np.int32) for s in new_blk_sizes]
    if len(new_sizes) != tensor.ndim:
        raise ValueError("need one block-size list per tensor dim")
    old_offs, new_offs, split_of = [], [], []
    for d in range(tensor.ndim):
        oo = np.concatenate([[0], np.cumsum(tensor.blk_sizes[d])])
        no = np.concatenate([[0], np.cumsum(new_sizes[d])])
        if oo[-1] != no[-1] or not np.isin(oo, no).all():
            raise ValueError(
                f"dim {d}: new blocking must refine the old (same total, "
                f"all old boundaries kept)"
            )
        old_offs.append(oo)
        new_offs.append(no)
        # for each new block: which old block contains it
        split_of.append(np.searchsorted(oo, no[:-1], side="right") - 1)
    out = BlockSparseTensor(
        name or tensor.name, new_sizes, tensor.row_dims, tensor.col_dims,
        tensor.dtype, tensor.device,
    )
    for idx, blk in tensor.iterate_blocks():
        # enumerate the new sub-blocks inside this old block, per dim
        per_dim = [
            np.nonzero(split_of[d] == idx[d])[0] for d in range(tensor.ndim)
        ]
        for sub in itertools.product(*per_dim):
            sl = tuple(
                slice(
                    int(new_offs[d][sub[d]] - old_offs[d][idx[d]]),
                    int(new_offs[d][sub[d] + 1] - old_offs[d][idx[d]]),
                )
                for d in range(tensor.ndim)
            )
            out.put_block(list(sub), blk[sl])
    return out.finalize()


def copy_matrix_to_tensor(matrix: BlockSparseMatrix,
                          tensor: BlockSparseTensor) -> BlockSparseTensor:
    """Fill a rank-2 tensor from a matrix with identical blocking
    (ref `dbcsr_t_copy_matrix_to_tensor`)."""
    if tensor.ndim != 2:
        raise ValueError("target tensor must be rank 2")
    if not (
        np.array_equal(tensor.blk_sizes[0], matrix.row_blk_sizes)
        and np.array_equal(tensor.blk_sizes[1], matrix.col_blk_sizes)
    ):
        raise ValueError("blockings differ")
    src = matrix if matrix.matrix_type == "N" else desymmetrize(matrix)
    tensor.clear()
    for r, c, blk in src.iterate_blocks():
        tensor.put_block((r, c), blk)
    return tensor.finalize()


def copy_tensor_to_matrix(tensor: BlockSparseTensor,
                          matrix: BlockSparseMatrix) -> BlockSparseMatrix:
    """Fill a matrix from a rank-2 tensor with identical blocking
    (ref `dbcsr_t_copy_tensor_to_matrix`)."""
    if tensor.ndim != 2:
        raise ValueError("source tensor must be rank 2")
    if not (
        np.array_equal(tensor.blk_sizes[0], matrix.row_blk_sizes)
        and np.array_equal(tensor.blk_sizes[1], matrix.col_blk_sizes)
    ):
        raise ValueError("blockings differ")
    ops.clear(matrix)
    for idx, blk in tensor.iterate_blocks():
        matrix.put_block(int(idx[0]), int(idx[1]), blk)
    return matrix.finalize()
