"""The multiply engine: C := alpha * op(A) * op(B) + beta * C.

Counterpart of `dbcsr_tpu/mm/multiply.py` (ref `dbcsr_multiply_generic`,
`src/mm/dbcsr_mm.F:336-1030`), stack format only:

* the symbolic product (every (i, k, j) triple) is computed up front on
  the host with NumPy (`_candidates_numpy`);
* C is restructured onto the product's pattern with beta applied on the
  device (`_rebuild_c`);
* the triples are grouped by shape-bin triple and sorted by
  (group, C slot, A entry) -- the JAX package's sort contract
  (`np.lexsort((a_ent, c_slot, group))`) -- and each group runs as one
  stack through `acc.smm` (`_run_stacks`).  Groups that share a C bin
  launch one after another on the current stream.

Accumulation order is fixed by the sort and the kernel's per-run loop,
so a run reproduces its checksums bit for bit.  Filtering follows the
reference (`dbcsr_mm.F:360-369`): skip a product when
||A_ik||^2 * ||B_kj||^2 < (eps / max(1, nblks in A's row i))^2 in single
precision, then drop C blocks with ||C||^2 < eps^2 unless
``retain_sparsity``.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from dbcsr_tpu_torch.acc.smm import StackPlan, execute_stack, prepare_stack
from dbcsr_tpu_torch.core.config import get_config
from dbcsr_tpu_torch.core.matrix import (
    BlockSparseMatrix,
    _Bin,
    _bin_entries,
    to_index,
)
from dbcsr_tpu_torch.ops.operations import compress
from dbcsr_tpu_torch.ops.transformations import new_transposed


def _real_scalar(x, dtype):
    """Coerce alpha/beta for a real-dtype product; a nonzero imaginary
    part raises a clear TypeError."""
    arr = np.asarray(x)
    if np.iscomplexobj(arr):
        if complex(arr).imag != 0.0:
            raise TypeError(
                f"complex alpha/beta with a real matrix C (dtype {dtype}); "
                f"use real scalars")
        return complex(arr).real
    return float(x)


def _effective(matrix: BlockSparseMatrix, trans: str) -> BlockSparseMatrix:
    """Resolve op(X) (ref transpose wrappers at `dbcsr_mm.F:521-582`);
    for the real dtypes ported, "C" is a plain transpose."""
    trans = trans.upper()
    if trans == "N":
        return matrix
    if trans in ("T", "C"):
        return new_transposed(matrix)
    raise ValueError(f"bad trans flag {trans!r}")


def multiply(
    transa: str,
    transb: str,
    alpha,
    matrix_a: BlockSparseMatrix,
    matrix_b: BlockSparseMatrix,
    beta,
    matrix_c: BlockSparseMatrix,
    retain_sparsity: bool = False,
    filter_eps: Optional[float] = None,
    first_row: Optional[int] = None,
    last_row: Optional[int] = None,
    first_col: Optional[int] = None,
    last_col: Optional[int] = None,
    first_k: Optional[int] = None,
    last_k: Optional[int] = None,
    element_limits=None,
) -> int:
    """Multiply two block-sparse matrices into ``matrix_c``; returns the
    true flop count.  Block and element limits are not ported yet."""
    if element_limits is not None or any(
            x is not None for x in (first_row, last_row, first_col, last_col,
                                    first_k, last_k)):
        raise NotImplementedError(
            "multiply limits (and their windowed beta) are not ported to "
            "dbcsr_tpu_torch yet")
    for m in (matrix_a, matrix_b, matrix_c):
        if not m.valid:
            m.finalize()
    # C may alias A or B (in-place squaring): C is restructured below
    if matrix_a is matrix_c:
        matrix_a = matrix_a.copy()
    if matrix_b is matrix_c:
        matrix_b = matrix_b.copy()
    a = _effective(matrix_a, transa)
    b = _effective(matrix_b, transb)
    c = matrix_c
    alpha, beta = (_real_scalar(x, c.dtype) for x in (alpha, beta))
    if not np.array_equal(a.col_blk_sizes, b.row_blk_sizes):
        raise ValueError("inner blockings of op(A), op(B) differ")
    if not np.array_equal(c.row_blk_sizes, a.row_blk_sizes):
        raise ValueError("C row blocking != op(A) row blocking")
    if not np.array_equal(c.col_blk_sizes, b.col_blk_sizes):
        raise ValueError("C col blocking != op(B) col blocking")
    if not (a.dtype == b.dtype == c.dtype):
        raise TypeError(f"dtypes of A/B/C differ: {a.dtype}/{b.dtype}/{c.dtype}")
    if not (a.device == b.device == c.device):
        raise ValueError(f"devices of A/B/C differ: {a.device}/{b.device}/{c.device}")
    return _multiply_body(a, b, c, alpha, beta, retain_sparsity, filter_eps)


def _multiply_body(a, b, c, alpha, beta, retain_sparsity, filter_eps) -> int:
    """The stack-format engine body.  Leaves the host seconds of each
    phase in ``c._mm_phase_s``, each span's (m, n, k, entries, kernel,
    longest run) in ``c._mm_spans`` and, on a CUDA device, a pair of
    CUDA events around the stack launches in ``c._mm_stack_events``."""
    c._mm_algorithm = get_config().mm_format  # "stack", the one format ported
    phase = {}
    t0 = time.perf_counter()
    i, j, a_ent, b_ent = _candidates(a, b, filter_eps)
    old_keys = c.keys
    cand_keys = i * c.nblkcols + j
    if retain_sparsity:
        ok = mask_in_sorted(cand_keys, old_keys)
        cand_keys, a_ent, b_ent = cand_keys[ok], a_ent[ok], b_ent[ok]
        new_keys = old_keys
    else:
        new_keys = np.union1d(old_keys, np.unique(cand_keys))
    t1 = time.perf_counter()
    phase["index"] = t1 - t0
    _rebuild_c(c, new_keys, beta)
    t2 = time.perf_counter()
    phase["assemble"] = t2 - t1
    spans = _build_spans(c, a, b, cand_keys, a_ent, b_ent)
    t3 = time.perf_counter()
    phase["plan"] = t3 - t2
    flops = _run_stacks(c, a, b, spans, alpha)
    phase["launch"] = time.perf_counter() - t3
    c._mm_phase_s = phase
    c._mm_spans = [(sp.m, sp.n, sp.k, sp.entries, sp.driver, sp.plan.max_run)
                   for sp in spans]
    if filter_eps is not None and not retain_sparsity:
        norms = c.block_norms()
        compress(c, norms ** 2 >= float(filter_eps) ** 2)
    return int(flops)


def mask_in_sorted(cand_keys: np.ndarray, sorted_keys: np.ndarray) -> np.ndarray:
    """Membership of each cand_key in sorted_keys (retain_sparsity)."""
    if len(sorted_keys) == 0:
        return np.zeros(len(cand_keys), bool)
    pos = np.searchsorted(sorted_keys, cand_keys)
    return (pos < len(sorted_keys)) & (
        sorted_keys[np.minimum(pos, len(sorted_keys) - 1)] == cand_keys)


def _candidates(a, b, filter_eps):
    """Symbolic product with the reference's on-the-fly norm filter:
    squared f32 norms and a per-A-row eps (`dbcsr_mm_cannon.F:1098-1105`)."""
    na2 = nb2 = row_eps = None
    if filter_eps is not None:
        na2 = a.block_norms().astype(np.float32) ** 2
        nb2 = b.block_norms().astype(np.float32) ** 2
        row_counts = np.diff(a.row_ptr)
        with np.errstate(over="ignore"):  # huge eps -> inf is a valid threshold
            row_eps = (np.float32(filter_eps)
                       / np.maximum(1, row_counts).astype(np.float32)) ** 2
    return _candidates_numpy(a, b, na2, nb2, row_eps)


def _candidates_numpy(a, b, na2, nb2, row_eps):
    """All (i, k, j) triples of op(A) * op(B) as parallel arrays
    (i, j, a_ent, b_ent): a_ent indexes A's entries, b_ent B's."""
    rows_a = np.repeat(np.arange(a.nblkrows, dtype=np.int64), np.diff(a.row_ptr))
    cols_a = (a.keys % a.nblkcols).astype(np.int64)  # k per A entry
    cols_b = (b.keys % b.nblkcols).astype(np.int64)  # j per B entry
    counts = (b.row_ptr[cols_a + 1] - b.row_ptr[cols_a]).astype(np.int64)
    tot = int(counts.sum())
    if tot == 0:
        z = np.empty(0, np.int64)
        return z, z, z, z
    a_ent = np.repeat(np.arange(len(a.keys), dtype=np.int64), counts)
    starts = np.cumsum(counts) - counts
    b_ent = (np.arange(tot, dtype=np.int64) - np.repeat(starts, counts)
             + np.repeat(b.row_ptr[cols_a], counts))
    i = rows_a[a_ent]
    j = cols_b[b_ent]
    if na2 is not None:
        keep = na2[a_ent] * nb2[b_ent] >= row_eps[i]
        if not keep.all():
            i, j, a_ent, b_ent = i[keep], j[keep], a_ent[keep], b_ent[keep]
    return i, j, a_ent, b_ent


def _rebuild_c(c: BlockSparseMatrix, new_keys: np.ndarray, beta) -> None:
    """Restructure C onto the (possibly grown) pattern, old blocks
    scaled by beta on the device, new blocks zero."""
    old_keys, old_bins = c.keys, c.bins
    old_ent_bin, old_ent_slot = c.ent_bin, c.ent_slot
    rows = (new_keys // c.nblkcols).astype(np.int64)
    cols = (new_keys % c.nblkcols).astype(np.int64)
    nb, nsl, shapes = _bin_entries(c.row_blk_sizes, c.col_blk_sizes, rows, cols)
    pos_old = np.searchsorted(new_keys, old_keys)  # old keys are in new keys
    counts = np.bincount(nb, minlength=len(shapes))
    bins = []
    for b_id, (bm, bn) in enumerate(shapes):
        data = torch.zeros((int(counts[b_id]), bm, bn), dtype=c.dtype,
                           device=c.device)
        sel = np.nonzero(nb[pos_old] == b_id)[0] if len(old_keys) else []
        if beta != 0 and len(sel):
            src = old_bins[old_ent_bin[sel[0]]].data
            data[to_index(nsl[pos_old[sel]], c.device)] = \
                beta * src[to_index(old_ent_slot[sel], c.device)]
        bins.append(_Bin((bm, bn), data, int(counts[b_id])))
    c.set_structure_from_device(new_keys, bins, binning=(nb, nsl, shapes))


class Span(NamedTuple):
    """One stack of the product: the bins it reads and writes, its block
    shape, its entry count, its prepared plan, and the kernel that plan
    chose (`StackPlan.kernel`)."""

    cbin: int
    abin: int
    bbin: int
    m: int
    n: int
    k: int
    entries: int
    plan: StackPlan
    driver: str


def _build_spans(c, a, b, cand_keys, a_ent, b_ent):
    """Group the triples by (C bin, A bin, B bin), sort each group by
    (C slot, A entry), and prepare one stack per group.  Returns the
    `Span`s in group order."""
    if len(cand_keys) == 0:
        return []
    c_ent = np.searchsorted(c.keys, cand_keys)
    cb = c.ent_bin[c_ent].astype(np.int64)
    ab = a.ent_bin[a_ent].astype(np.int64)
    bb = b.ent_bin[b_ent].astype(np.int64)
    c_slot = c.ent_slot[c_ent]
    g = (cb * len(a.bins) + ab) * len(b.bins) + bb
    order = np.lexsort((a_ent, c_slot, g))
    bounds = np.concatenate(
        [[0], np.cumsum(np.bincount(g, minlength=len(c.bins) * len(a.bins) * len(b.bins)))])
    c_slot = c_slot[order]
    a_slot = a.ent_slot[a_ent][order]
    b_slot = b.ent_slot[b_ent][order]
    spans = []
    for gi in np.nonzero(np.diff(bounds))[0]:
        s0, s1 = int(bounds[gi]), int(bounds[gi + 1])
        abin = int(ab[order[s0]])
        bbin = int(bb[order[s0]])
        cbin = int(cb[order[s0]])
        m, k = a.bins[abin].shape
        n = b.bins[bbin].shape[1]
        plan = prepare_stack(c.bins[cbin].data, a.bins[abin].data, b.bins[bbin].data,
                             a_slot[s0:s1], b_slot[s0:s1], c_slot[s0:s1])
        spans.append(Span(cbin, abin, bbin, m, n, k, s1 - s0, plan, plan.kernel))
    return spans


def _run_stacks(c, a, b, spans, alpha) -> int:
    """Execute the prepared spans in order, in place on C's bins; returns
    the true flops."""
    events = None
    if c.device.type == "cuda" and spans:
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    flops = 0
    for sp in spans:
        execute_stack(c.bins[sp.cbin].data, a.bins[sp.abin].data,
                      b.bins[sp.bbin].data, sp.plan, alpha)
        flops += 2 * sp.m * sp.n * sp.k * sp.entries
    if events is not None:
        events[1].record()
    c._mm_stack_events = events
    return flops
