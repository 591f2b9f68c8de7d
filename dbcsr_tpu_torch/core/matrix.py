"""The block-sparse matrix type.

Counterpart of `dbcsr_tpu/core/matrix.py` (ref `dbcsr_type`,
`src/core/dbcsr_types.F:363-461`), with the same data model:

* Host index (NumPy): sorted int64 keys ``row * nblkcols + col``, the
  derived ``row_ptr``, and for each entry its shape bin (``ent_bin``)
  and slot within the bin (``ent_slot``).
* Device data: one torch tensor per distinct block shape, of shape
  ``(count, bm, bn)`` -- the "shape bins" the stack kernel indexes into.
  Unlike the JAX package there is no jit cache to feed, so a bin's
  capacity equals its count (no bucket padding, no pad rows).
* Assembly goes through a host work buffer then `finalize()` (ref
  `dbcsr_finalize`, `src/work/dbcsr_work_operations.F:749`).

Tensors are mutable here: the multiply engine updates C's bins in
place, and `copy()` therefore clones the data.  Symmetric,
antisymmetric and hermitian matrices store the canonical upper triangle
only (row <= col), as the reference does: `put_block` folds a
lower-triangle write onto the stored transpose (conjugated for a
hermitian kind; a real hermitian matrix is symmetric) and `get_block`
unfolds it.  A matrix created inside a `core.mempool.chain` is adopted
by it.

The mutation journal (ref `dbcsr_tpu/core/matrix.py:141-152,694-745`):
every funnel that changes values bumps ``mutation_epoch`` and records
the block keys it touched, or None for a change of structure;
`dirty_keys_since` answers which keys may have changed since an epoch,
or None when it cannot tell.  The incremental multiply
(`mm/incremental.py`) keys its reuse on it.  Bins that a cache holds
(``_bins_shared``) are copy-on-write: `own_bins` gives the matrix fresh
clones before any in-place write, so a cached result is never written
through (the JAX package needs no such rule: its arrays are immutable).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from dbcsr_tpu_torch.core import digests, mempool
from dbcsr_tpu_torch.core.dist import Distribution
from dbcsr_tpu_torch.core.kinds import dtype_of, host_dtype, name_of, real_dtype_of
from dbcsr_tpu_torch.device import DeviceLike, resolve_device

# matrix_type flags, ref dbcsr_type_no_symmetry/_symmetric/_antisymmetric/
# _hermitian in src/core/dbcsr_types.F
NO_SYMMETRY = "N"
SYMMETRIC = "S"
ANTISYMMETRIC = "A"
HERMITIAN = "H"
MATRIX_TYPES = (NO_SYMMETRY, SYMMETRIC, ANTISYMMETRIC, HERMITIAN)


@dataclasses.dataclass
class _Bin:
    """One block-shape bin: a device tensor of same-shape blocks."""

    shape: Tuple[int, int]
    data: torch.Tensor  # (count, bm, bn)
    count: int


def _fold_block(block: np.ndarray, matrix_type: str) -> np.ndarray:
    """A lower-triangle block's stored upper-triangle image."""
    if matrix_type == SYMMETRIC:
        return block.T
    if matrix_type == ANTISYMMETRIC:
        return -block.T
    if matrix_type == HERMITIAN:
        return block.conj().T
    raise AssertionError(matrix_type)


def to_host(t: torch.Tensor) -> np.ndarray:
    """Fetch a tensor to a numpy array (bf16 widens to float32)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().resolve_conj().numpy()


def to_index(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a host index array as an int64 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(idx, np.int64)).to(device)


def to_device(arr: np.ndarray, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """Upload a host block array as ``dtype`` on ``device``."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # torch.from_numpy wants a writable buffer
        arr = arr.copy()
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


# bytes of blocks one gather moves at a time: a bin of a large matrix
# (18.6 GB for the 3-center tensor of the water system) is never copied
# whole into a temporary
_MOVE_CHUNK_BYTES = 1 << 28


def move_blocks(dst: torch.Tensor, dst_slots: np.ndarray, src: torch.Tensor,
                src_slots: np.ndarray, factor=None) -> None:
    """``dst[dst_slots] = src[src_slots]`` (times ``factor`` when given),
    one bounded chunk of blocks at a time, so the gather's temporary
    stays small whatever the bin's size."""
    n = len(dst_slots)
    per = max(1, _MOVE_CHUNK_BYTES // max(1, src[0].numel() * src.element_size()))
    for s0 in range(0, n, per):
        blocks = src[to_index(src_slots[s0: s0 + per], src.device)]
        if factor is not None:
            blocks.mul_(factor)
        dst[to_index(dst_slots[s0: s0 + per], dst.device)] = blocks


class BlockSparseMatrix:
    """A block-compressed sparse row matrix on one device."""

    def __init__(
        self,
        name: str,
        row_blk_sizes,
        col_blk_sizes,
        dtype=torch.float64,
        dist: Optional[Distribution] = None,
        matrix_type: str = NO_SYMMETRY,
        device: Optional[DeviceLike] = None,
    ):
        if matrix_type not in MATRIX_TYPES:
            raise ValueError(f"matrix_type must be one of {MATRIX_TYPES}, "
                             f"got {matrix_type!r}")
        self.device = resolve_device(device)
        self.name = name
        self.row_blk_sizes = np.ascontiguousarray(row_blk_sizes, np.int32)
        self.col_blk_sizes = np.ascontiguousarray(col_blk_sizes, np.int32)
        self.dtype = dtype_of(dtype)
        if matrix_type != NO_SYMMETRY:
            if not np.array_equal(self.row_blk_sizes, self.col_blk_sizes):
                raise ValueError("symmetric matrix needs identical row/col blocking")
            if matrix_type == HERMITIAN and not self.dtype.is_complex:
                matrix_type = SYMMETRIC  # a real hermitian matrix is symmetric
        self.matrix_type = matrix_type
        self.dist = dist or Distribution.trivial(
            len(self.row_blk_sizes), len(self.col_blk_sizes))
        if (self.dist.nblkrows, self.dist.nblkcols) != (
                self.nblkrows, self.nblkcols):
            raise ValueError("distribution does not match the blocking")
        self.keys = np.empty(0, np.int64)
        self.row_ptr = np.zeros(self.nblkrows + 1, np.int64)
        self.ent_bin = np.empty(0, np.int32)
        self.ent_slot = np.empty(0, np.int32)
        self.bins: List[_Bin] = []
        self.valid = True
        # pre-finalize work buffer: (row, col) -> host block
        self._work: Dict[Tuple[int, int], np.ndarray] = {}
        # batched staging: (keys int64, blocks (N, bm, bn), summation)
        self._work_batches: List[Tuple[np.ndarray, np.ndarray, bool]] = []
        # the dense format's cached canvas (mm/multiply.py:_dense_canvas_cached)
        self._dense_canvas = None
        # block_norms' memo: (held arrays, bin versions, norms)
        self._norms_memo = None
        # a cache holds these bins: write only after `own_bins`
        self._bins_shared = False
        # the mutation journal: a monotone epoch and the (epoch, keys or
        # None) entries since the last change of structure; `copy` starts
        # its own
        self._epoch = 0
        self._delta_log: List = []
        ch = mempool.current_chain()
        if ch is not None:
            ch.adopt(self)

    # ---------------------------------------------------------------- shape
    @property
    def nblkrows(self) -> int:
        return len(self.row_blk_sizes)

    @property
    def nblkcols(self) -> int:
        return len(self.col_blk_sizes)

    @property
    def nfullrows(self) -> int:
        return int(self.row_blk_sizes.sum())

    @property
    def nfullcols(self) -> int:
        return int(self.col_blk_sizes.sum())

    @property
    def row_blk_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.row_blk_sizes)]).astype(np.int64)

    @property
    def col_blk_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.col_blk_sizes)]).astype(np.int64)

    @property
    def nblks(self) -> int:
        return len(self.keys)

    @property
    def nnz(self) -> int:
        rows, cols = self.entry_coords()
        return int((self.row_blk_sizes[rows].astype(np.int64)
                    * self.col_blk_sizes[cols]).sum())

    def occupation(self) -> float:
        """Fraction of nonzero elements (ref dbcsr_get_occupation)."""
        full = self.nfullrows * self.nfullcols
        return self.nnz / full if full else 0.0

    def setname(self, name: str) -> None:
        """Ref `dbcsr_setname`."""
        self.name = str(name)

    def get_info(self) -> dict:
        """Structure summary (ref `dbcsr_get_info`, `dbcsr_api.F`); a
        bin's capacity is its count, so ``data_size`` is the stored
        element count."""
        return {
            "name": self.name,
            "matrix_type": self.matrix_type,
            "data_type": name_of(self.dtype),
            "nblkrows_total": self.nblkrows,
            "nblkcols_total": self.nblkcols,
            "nfullrows_total": self.nfullrows,
            "nfullcols_total": self.nfullcols,
            "nblks": self.nblks,
            "nze": self.nnz,
            "data_size": int(sum(b.count * b.shape[0] * b.shape[1] for b in self.bins)),
            "occupation": self.occupation(),
            "row_blk_sizes": self.row_blk_sizes.copy(),
            "col_blk_sizes": self.col_blk_sizes.copy(),
            "row_blk_offsets": self.row_blk_offsets[:-1].copy(),
            "col_blk_offsets": self.col_blk_offsets[:-1].copy(),
            "distribution": self.dist,
        }

    def block_shape(self, row: int, col: int) -> Tuple[int, int]:
        return int(self.row_blk_sizes[row]), int(self.col_blk_sizes[col])

    def entry_coords(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, cols) arrays for all finalized entries, key-ordered."""
        return ((self.keys // self.nblkcols).astype(np.int64),
                (self.keys % self.nblkcols).astype(np.int64))

    def get_stored_coordinates(self, row: int, col: int):
        """Owning (prow, pcol) of a block under this matrix's
        distribution (ref `dbcsr_get_stored_coordinates`): the canonical
        triangle owns a symmetric matrix's block."""
        if self.matrix_type != NO_SYMMETRY and row > col:
            row, col = col, row
        return self.dist.stored_coordinates(row, col)

    def _canonicalize(self, row: int, col: int, block):
        if not (0 <= row < self.nblkrows and 0 <= col < self.nblkcols):
            raise IndexError(f"block ({row},{col}) out of range")
        if self.matrix_type != NO_SYMMETRY and row > col:
            if block is not None:
                block = _fold_block(block, self.matrix_type)
            row, col = col, row
        return row, col, block

    # ------------------------------------------------------------- assembly
    def put_block(self, row: int, col: int, block, summation: bool = False) -> None:
        """Stage a block for the next `finalize` (ref `dbcsr_put_block`);
        a symmetric matrix folds a lower-triangle block onto its stored
        transpose."""
        row, col, block = self._canonicalize(row, col, np.asarray(block))
        bm, bn = self.block_shape(row, col)
        if block.shape != (bm, bn):
            raise ValueError(
                f"block ({row},{col}) has shape {block.shape}, expected {(bm, bn)}")
        block = block.astype(host_dtype(self.dtype), copy=True)
        key = (row, col)
        if summation and key in self._work:
            self._work[key] = self._work[key] + block
        elif summation and self._find_entry(row, col) >= 0:
            self._work[key] = self.get_block(row, col) + block
        else:
            self._work[key] = block
        self.valid = False

    def put_blocks(self, rows, cols, blocks, summation: bool = False) -> None:
        """Stage many blocks at once; ``blocks`` is an (N, bm, bn) array
        or a list of 2-D arrays.  Applied at `finalize` after the single
        `put_block` stagings, in call order; duplicates within one call
        are summed when ``summation``, last-write-wins otherwise."""
        self._work_batches.extend(self._make_batches(rows, cols, blocks, summation))
        self.valid = False

    def stage_device_blocks(self, rows, cols, blocks: torch.Tensor,
                            summation: bool = False) -> None:
        """Stage an (N, bm, bn) tensor of same-shape blocks that already
        lies on the device, without a host round-trip: the device-side
        sibling of `put_blocks` (the tensor layer's remap and copy, ref
        `dbcsr_t_reshape`'s block alltoall, `dbcsr_tensor_reshape.F:67,288`).
        The batch merges at `finalize` like a host batch, into new bins
        (so every bin written is a new tensor, and caches keyed on the
        old bins' identity or version miss).

        Caller contract, as in the JAX package: (row, col) pairs are
        unique within the batch, and the matrix has no symmetry (device
        blocks are not folded)."""
        if self.matrix_type != NO_SYMMETRY:
            raise NotImplementedError("stage_device_blocks requires a non-symmetric matrix")
        rows = np.ascontiguousarray(rows, np.int64)
        cols = np.ascontiguousarray(cols, np.int64)
        if blocks.dim() != 3 or len(rows) != len(cols) or len(rows) != blocks.shape[0]:
            raise ValueError("rows/cols/blocks length mismatch")
        if len(rows) == 0:
            return
        if rows.min() < 0 or rows.max() >= self.nblkrows or cols.min() < 0 \
                or cols.max() >= self.nblkcols:
            raise IndexError("block coordinates out of range")
        bm, bn = int(blocks.shape[1]), int(blocks.shape[2])
        if not (np.all(self.row_blk_sizes[rows] == bm) and np.all(self.col_blk_sizes[cols] == bn)):
            raise ValueError(f"batch of shape ({bm},{bn}) does not match "
                             f"the blocking at all its coordinates")
        if blocks.device != self.device:
            raise ValueError(f"blocks lie on {blocks.device}, the matrix on {self.device}")
        keys = rows * self.nblkcols + cols
        self._work_batches.append((keys, blocks.to(self.dtype), summation))
        self.valid = False

    def reserve_block(self, row: int, col: int) -> None:
        """Ref `dbcsr_reserve_block2d`: allocate a zero block."""
        row, col, _ = self._canonicalize(row, col, None)
        if (row, col) not in self._work and self._find_entry(row, col) < 0:
            self._work[(row, col)] = np.zeros(self.block_shape(row, col),
                                              host_dtype(self.dtype))
            self.valid = False

    def _make_batches(self, rows, cols, blocks, summation: bool):
        """Fold (symmetric kinds), validate, group by block shape and
        pre-reduce duplicates; returns [(keys, (N, bm, bn) host array,
        summation)]."""
        rows = np.ascontiguousarray(rows, np.int64)
        cols = np.ascontiguousarray(cols, np.int64)
        if len(rows) != len(cols):
            raise ValueError("rows/cols length mismatch")
        if len(rows) == 0:
            return []
        if rows.min() < 0 or rows.max() >= self.nblkrows or cols.min() < 0 \
                or cols.max() >= self.nblkcols:
            raise IndexError("block coordinates out of range")
        if len(blocks) != len(rows):
            raise ValueError("blocks length mismatch")
        hdt = host_dtype(self.dtype)
        # fold before grouping: folding transposes a block, which moves a
        # rectangular off-diagonal block to another shape group
        if self.matrix_type != NO_SYMMETRY:
            fold = rows > cols
            if fold.any():
                blocks = [_fold_block(np.asarray(blocks[i]), self.matrix_type)
                          if fold[i] else np.asarray(blocks[i]) for i in range(len(rows))]
                rows, cols = np.where(fold, cols, rows), np.where(fold, rows, cols)
        if isinstance(blocks, np.ndarray) and blocks.ndim == 3:
            groups = [(np.arange(len(rows)), blocks.astype(hdt))]
        else:
            shapes = np.array([np.shape(b) for b in blocks], np.int64)
            code = shapes[:, 0] << 32 | shapes[:, 1]
            groups = []
            for u in np.unique(code):
                idx = np.nonzero(code == u)[0]
                groups.append(
                    (idx, np.stack([np.asarray(blocks[i]) for i in idx]).astype(hdt)))
        out = []
        for idx, arr in groups:
            r, c = rows[idx], cols[idx]
            bm, bn = arr.shape[1], arr.shape[2]
            if not (np.all(self.row_blk_sizes[r] == bm)
                    and np.all(self.col_blk_sizes[c] == bn)):
                raise ValueError(f"batch of shape ({bm},{bn}) does not match "
                                 f"the blocking at all its coordinates")
            keys = r * self.nblkcols + c
            if len(np.unique(keys)) != len(keys):
                if summation:
                    uniq, inv = np.unique(keys, return_inverse=True)
                    red = np.zeros((len(uniq), bm, bn), hdt)
                    np.add.at(red, inv, arr)
                    keys, arr = uniq, red
                else:
                    uniq, first_rev = np.unique(keys[::-1], return_index=True)
                    keys, arr = uniq, arr[len(keys) - 1 - first_rev]
            out.append((keys, arr, summation))
        return out

    def finalize(self) -> "BlockSparseMatrix":
        """Merge staged blocks into the index (ref `dbcsr_finalize` ->
        `dbcsr_merge_all`).  Surviving blocks move bin to bin on the
        device; only the staged host blocks are uploaded."""
        if not self._work and not self._work_batches:
            self.valid = True
            return self
        if self._work:
            # single-put stagings become a leading replace batch
            self._work_batches = self._make_batches(
                np.array([r for (r, _) in self._work], np.int64),
                np.array([c for (_, c) in self._work], np.int64),
                list(self._work.values()), False) + self._work_batches
            self._work.clear()
        staged_keys = np.unique(np.concatenate([k for (k, _, _) in self._work_batches]))
        merged = np.union1d(self.keys, staged_keys)
        # a same-pattern finalize (a loop's value update) journals exactly
        # the staged keys; a new key changes the structure
        same_pattern = len(merged) == len(self.keys)
        rows = (merged // self.nblkcols).astype(np.int64)
        cols = (merged % self.nblkcols).astype(np.int64)
        nb, nsl, shapes = _bin_entries(self.row_blk_sizes, self.col_blk_sizes,
                                       rows, cols)
        shape_to_bin = {s: i for i, s in enumerate(shapes)}
        counts = np.bincount(nb, minlength=len(shapes))
        datas = [torch.zeros((int(counts[i]), bm, bn), dtype=self.dtype,
                             device=self.device)
                 for i, (bm, bn) in enumerate(shapes)]
        # 1) surviving old blocks: device-to-device move per shape
        if len(self.keys):
            pos_old = np.searchsorted(merged, self.keys)
            new_bin_of_old = nb[pos_old]
            for b in range(len(shapes)):
                old_sel = np.nonzero(new_bin_of_old == b)[0]
                if not len(old_sel):
                    continue
                src = self.bins[self.ent_bin[old_sel[0]]].data
                move_blocks(datas[b], nsl[pos_old[old_sel]], src, self.ent_slot[old_sel])
        # 2) staged batches in call order (each is one shape -> one bin);
        # a batch is a host array, or a device tensor (`stage_device_blocks`)
        for keys_b, arr, summation in self._work_batches:
            b = shape_to_bin[(int(arr.shape[1]), int(arr.shape[2]))]
            slots = to_index(nsl[np.searchsorted(merged, keys_b)], self.device)
            blocks = arr if isinstance(arr, torch.Tensor) else to_device(arr, self.dtype,
                                                                        self.device)
            if summation:
                datas[b].index_add_(0, slots, blocks)
            else:
                datas[b][slots] = blocks
        bins = [_Bin(s, datas[i], int(counts[i])) for i, s in enumerate(shapes)]
        self._work_batches.clear()
        self.set_structure_from_device(merged, bins, binning=(nb, nsl, shapes),
                                       value_delta_keys=staged_keys if same_pattern else None)
        return self

    def set_structure_from_device(self, keys: np.ndarray, bins: List[_Bin],
                                  binning=None, value_delta_keys=None) -> None:
        """Adopt a prebuilt index + device bins (the multiply engine
        assembles C on the device).  ``binning`` optionally carries a
        precomputed `_bin_entries` result.  ``value_delta_keys`` names
        the keys whose values changed when the pattern did not (a
        same-pattern finalize); None journals a change of structure.
        The bins must be fresh tensors no other matrix holds, so the
        matrix owns them again (``_bins_shared`` clears)."""
        keys = np.ascontiguousarray(keys, np.int64)
        rows = (keys // self.nblkcols).astype(np.int64)
        cols = (keys % self.nblkcols).astype(np.int64)
        if binning is None:
            binning = _bin_entries(self.row_blk_sizes, self.col_blk_sizes, rows, cols)
        bin_ids, slots, shapes = binning
        self.keys = keys
        self.row_ptr = np.zeros(self.nblkrows + 1, np.int64)
        self.row_ptr[1:] = np.cumsum(np.bincount(rows, minlength=self.nblkrows))
        self.ent_bin = bin_ids
        self.ent_slot = slots
        by_shape = {b.shape: b for b in bins}
        self.bins = [by_shape[(int(bm), int(bn))] for (bm, bn) in shapes]
        self._dense_canvas = None
        self._work.clear()
        self._work_batches.clear()
        self._bins_shared = False
        self._note_mutation(value_delta_keys)
        self.valid = True

    # ------------------------------------------------------ value deltas
    # a bounded journal: a baseline older than it reaches reads as
    # unknown (a full recompute), never as a wrong delta
    _DELTA_LOG_MAX = 64

    @property
    def mutation_epoch(self) -> int:
        """The monotone mutation counter: every value funnel bumps it."""
        return self._epoch

    def _note_mutation(self, keys) -> None:
        """Journal one mutation: ``keys``, the int64 block keys whose
        values it changed (structure unchanged), or None for a change of
        structure or an unknown extent, which restarts the journal."""
        self._epoch += 1
        if keys is None:
            self._delta_log = [(self._epoch, None)]
            return
        self._delta_log.append((self._epoch, np.asarray(keys, np.int64)))
        if len(self._delta_log) > self._DELTA_LOG_MAX:
            del self._delta_log[0]

    def dirty_keys_since(self, epoch: int):
        """The block keys whose values may have changed since ``epoch`` (a
        `mutation_epoch` read earlier): an int64 array, empty when none
        did, or None when the journal cannot tell (a change of structure,
        a truncated journal, an epoch this matrix never had)."""
        if epoch == self._epoch:
            return np.empty(0, np.int64)
        if epoch > self._epoch or not self._delta_log:
            return None
        if epoch < self._delta_log[0][0] - 1:
            return None  # the journal no longer reaches the baseline
        parts = []
        for e, k in self._delta_log:
            if e <= epoch:
                continue
            if k is None:
                return None
            parts.append(k)
        if not parts:
            return None  # the epoch lies inside a restarted journal
        return np.unique(np.concatenate(parts))

    def own_bins(self) -> None:
        """Copy-on-write: while a cache holds this matrix's bins
        (``_bins_shared``), replace them by clones, so the next in-place
        write reaches this matrix alone.  Every in-place writer calls it
        first."""
        if self._bins_shared:
            for b in self.bins:
                b.data = b.data.clone()
            self._bins_shared = False

    def map_bin_data(self, fn) -> None:
        """Apply ``fn`` to every non-empty bin's device data (its result
        becomes the bin; ``fn`` may write in place) and journal every
        stored key (ref `dbcsr_tpu/core/matrix.py:772-800`)."""
        self.own_bins()
        for b in self.bins:
            if b.count:
                b.data = fn(b.data)
        self._dense_canvas = None
        self._note_mutation(self.keys)

    def zero_data(self) -> None:
        """Set every stored value to zero; the pattern is kept."""
        self.map_bin_data(lambda d: d.zero_())

    # --------------------------------------------------------------- access
    def _find_entry(self, row: int, col: int) -> int:
        key = row * self.nblkcols + col
        i = np.searchsorted(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            return int(i)
        return -1

    def get_block(self, row: int, col: int, unfold: bool = True) -> Optional[np.ndarray]:
        """Fetch one block to the host; None if absent (ref
        `dbcsr_get_block_p`).  A symmetric matrix's lower-triangle block
        comes unfolded from its stored transpose unless ``unfold`` is
        False."""
        srow, scol, folded = row, col, False
        if self.matrix_type != NO_SYMMETRY and row > col:
            srow, scol, folded = col, row, True
        if (srow, scol) in self._work:
            blk = self._work[(srow, scol)].copy()
        else:
            e = self._find_entry(srow, scol)
            if e < 0:
                return None
            blk = to_host(self.bins[self.ent_bin[e]].data[int(self.ent_slot[e])])
        if folded and unfold:
            blk = _fold_block(blk, self.matrix_type)
        return blk

    def get_blocks(self, rows, cols, unfold: bool = True) -> List:
        """Fetch many blocks with one device gather per shape bin instead
        of one copy per block (ref `dbcsr_tpu/core/matrix.py:574`): a
        list aligned with ``rows``/``cols``, None where a block is
        absent; blocks still in the work buffer come from the host."""
        rows = np.ascontiguousarray(rows, np.int64)
        cols = np.ascontiguousarray(cols, np.int64)
        if len(rows) != len(cols):
            raise ValueError("rows/cols length mismatch")
        n = len(rows)
        out: List = [None] * n
        if n == 0:
            return out
        if rows.min() < 0 or rows.max() >= self.nblkrows or cols.min() < 0 \
                or cols.max() >= self.nblkcols:
            raise IndexError("block coordinates out of range")
        folded = np.zeros(n, bool)
        srows, scols = rows, cols
        if self.matrix_type != NO_SYMMETRY:
            folded = rows > cols
            srows, scols = np.where(folded, cols, rows), np.where(folded, rows, cols)
        keys = srows * self.nblkcols + scols
        pos = np.minimum(np.searchsorted(self.keys, keys), max(len(self.keys) - 1, 0))
        found = (self.keys[pos] == keys) if len(self.keys) else np.zeros(n, bool)
        for b_id, b in enumerate(self.bins):
            sel = np.nonzero(found & (self.ent_bin[pos] == b_id))[0]
            if len(sel):
                fetched = to_host(b.data[to_index(self.ent_slot[pos[sel]], b.data.device)])
                for i, e in enumerate(sel):
                    out[e] = fetched[i]
        for e in range(n):
            key = (int(srows[e]), int(scols[e]))
            if key in self._work:
                out[e] = self._work[key].copy()
            if out[e] is not None and folded[e] and unfold:
                out[e] = _fold_block(out[e], self.matrix_type)
        return out

    def iterate_blocks(self) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Iterate stored blocks in index order (ref `dbcsr_iterator_*`);
        fetches each bin from the device once."""
        if not self.valid:
            raise RuntimeError("finalize() before iterating")
        host_bins = [to_host(b.data[: b.count]) for b in self.bins]
        rows, cols = self.entry_coords()
        for e in range(self.nblks):
            yield int(rows[e]), int(cols[e]), host_bins[self.ent_bin[e]][self.ent_slot[e]]

    def block_norms(self) -> np.ndarray:
        """Frobenius norm per finalized entry, key-ordered, computed on
        the device in the matrix dtype as the JAX package does (bf16
        sums in float32 and rounds the norm back to bf16).  Read-only.

        While `core.mempool` is enabled the result is memoized, as the
        JAX package memoizes it on the bins' identity
        (`dbcsr_tpu/core/matrix.py:643-668`): here on the identity of the
        index arrays and the bins and on each bin's `tensor._version`,
        since the port writes bins in place (every torch in-place op and
        every kernel wrapper, `acc.stack_kernel.mark_written`, bumps it).
        A kernel write, a corrupting fault, a retry that restores C and a
        `chain.restore` all miss the memo.  It holds the arrays, so an
        identity cannot be reused."""
        held = (self.keys, self.ent_bin, self.ent_slot, *(b.data for b in self.bins))
        versions = tuple(b.data._version for b in self.bins)
        memo = self._norms_memo
        if (mempool.enabled() and memo is not None and memo[1] == versions
                and len(memo[0]) == len(held) and all(x is y for x, y in zip(memo[0], held))):
            return memo[2]
        out = np.zeros(self.nblks, np.float64)
        for b_id, b in enumerate(self.bins):
            if b.count == 0:
                continue
            d = b.data
            acc = torch.float32 if d.dtype == torch.bfloat16 else d.dtype
            real = real_dtype_of(d.dtype)
            # a bounded chunk of blocks at a time: the squares' temporary
            # is never the size of a large bin (each norm is the same);
            # a complex block sums |x|^2 in its real dtype
            per = max(1, _MOVE_CHUNK_BYTES // max(1, d[0].numel() * d.element_size()))
            norms = torch.cat([
                torch.sqrt((x * x.conj()).real.sum(dim=(1, 2)) if x.is_complex()
                           else (x * x).sum(dim=(1, 2), dtype=acc)).to(real)
                for x in d.split(per)])
            mask = self.ent_bin == b_id
            out[mask] = to_host(norms).astype(np.float64)[self.ent_slot[mask]]
        out.setflags(write=False)
        self._norms_memo = (held, versions, out) if mempool.enabled() else None
        return out

    def pattern_fingerprint(self) -> tuple:
        """Content hash of the sparsity pattern: the keys, the blocking
        vectors and the entries' bin and slot (plans index bins by id and
        slot), memoized on the identity of the keys and binning arrays.
        Every structure change replaces those arrays rather than writing
        into them, and the memo holds them, so an identity cannot be
        reused.  Keys the multiply's plan cache (ref
        `dbcsr_tpu/core/matrix.py:672-692`, which hashes keys and
        blocking)."""
        if getattr(self, "_blk_fp", None) is None:
            self._blk_fp = digests.digest(self.row_blk_sizes.tobytes(),
                                          self.col_blk_sizes.tobytes())[:8]
        src = getattr(self, "_fp_src", (None, None, None))
        if src[0] is not self.keys or src[1] is not self.ent_bin or src[2] is not self.ent_slot:
            self._fp_src = (self.keys, self.ent_bin, self.ent_slot)
            shapes = np.asarray([b.shape for b in self.bins], np.int64)
            self._fp = (self.nblkrows, self.nblkcols, len(self.keys), self._blk_fp,
                        digests.index_digest(self.keys, self.ent_bin, self.ent_slot,
                                             shapes)[:8])
        return self._fp

    def free(self) -> None:
        """Drop this matrix's device storage (the `dbcsr_release` analog):
        its bins return to the caching allocator once no other tensor
        references them; the matrix is emptied and marked invalid."""
        mempool.note_freed(sum(b.data.numel() * b.data.element_size() for b in self.bins))
        self.bins = []
        self.keys = np.empty(0, np.int64)
        self.row_ptr = np.zeros(self.nblkrows + 1, np.int64)
        self.ent_bin = np.empty(0, np.int32)
        self.ent_slot = np.empty(0, np.int32)
        self._dense_canvas = None
        self._norms_memo = None
        self._work.clear()
        self._work_batches.clear()
        self._bins_shared = False
        self._note_mutation(None)  # emptied: nothing reusable remains
        self.valid = False

    def copy(self, name: Optional[str] = None) -> "BlockSparseMatrix":
        """Deep copy: bins are cloned, since the engine updates C in place.
        The copy starts its own mutation journal (ref
        `dbcsr_tpu/core/matrix.py:747-770`: delta state is never shared)."""
        m = BlockSparseMatrix(name or self.name, self.row_blk_sizes,
                              self.col_blk_sizes, self.dtype, self.dist,
                              self.matrix_type, device=self.device)
        m.keys = self.keys.copy()
        m.row_ptr = self.row_ptr.copy()
        m.ent_bin = self.ent_bin.copy()
        m.ent_slot = self.ent_slot.copy()
        m.bins = [_Bin(b.shape, b.data.clone(), b.count) for b in self.bins]
        m._work = {k: v.copy() for k, v in self._work.items()}
        m._work_batches = [(k.copy(), a.clone() if isinstance(a, torch.Tensor) else a.copy(), s)
                           for (k, a, s) in self._work_batches]
        m.valid = self.valid
        return m

    def __repr__(self) -> str:
        return (f"BlockSparseMatrix({self.name!r}, {self.nblkrows}x{self.nblkcols} "
                f"blocks, {self.nblks} stored, dtype={self.dtype}, "
                f"type={self.matrix_type}, device={self.device})")


def _bin_entries(row_blk_sizes, col_blk_sizes, rows, cols):
    """Assign each entry a shape-bin id and an in-bin slot (key order).

    Distinct block sizes are few (ref `dbcsr_mm_common.F:309`), so bin
    ids come from a small size->id table and slots from per-bin counts.
    """
    n = len(rows)
    if n == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32), []
    ur = np.unique(row_blk_sizes)
    uc = np.unique(col_blk_sizes)
    if len(ur) * len(uc) > max(4 * n, 1 << 20):
        code64 = row_blk_sizes[rows].astype(np.int64) << 32 | col_blk_sizes[cols]
        uniq, inv = np.unique(code64, return_inverse=True)
        inv = inv.astype(np.int32)
        shapes = [(int(u >> 32), int(u & 0xFFFFFFFF)) for u in uniq]
    else:
        rid = np.searchsorted(ur, row_blk_sizes[rows])
        cid = np.searchsorted(uc, col_blk_sizes[cols])
        code = rid.astype(np.int32) * len(uc) + cid
        counts_all = np.bincount(code, minlength=len(ur) * len(uc))
        present = np.nonzero(counts_all)[0]
        remap = np.zeros(len(ur) * len(uc), np.int32)
        remap[present] = np.arange(len(present), dtype=np.int32)
        inv = remap[code]
        shapes = [(int(ur[p // len(uc)]), int(uc[p % len(uc)])) for p in present]
    nbins = len(shapes)
    if nbins == 1:
        return inv, np.arange(n, dtype=np.int32), shapes
    counts = np.bincount(inv, minlength=nbins)
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    order = np.argsort(inv, kind="stable")
    slots = np.empty(n, np.int32)
    slots[order] = (np.arange(n) - np.repeat(starts, counts)).astype(np.int32)
    return inv, slots, shapes

