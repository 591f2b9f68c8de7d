"""The multiply engine: C := alpha * op(A) * op(B) + beta * C.

Counterpart of `dbcsr_tpu/mm/multiply.py` (ref `dbcsr_multiply_generic`,
`src/mm/dbcsr_mm.F:336-1030`).  `mm/format_planner.py` picks one of
three executions of the same product:

* stack: the symbolic product (every (i, k, j) triple) is computed up
  front on the host by the native index engine (`native/`; the NumPy
  path `_candidates_numpy` when ``DBCSR_TPU_TORCH_NATIVE=0``); C is
  restructured onto the product's pattern with beta applied on the
  device (`_rebuild_c`); the triples are grouped by shape-bin triple and
  sorted by (group, C slot, A entry) -- the JAX package's sort contract
  (`np.lexsort((a_ent, c_slot, group))`) -- and each group runs as one
  stack through `acc.smm` (`_run_stacks`);
* dense: A and B are scattered onto dense canvases on the device, one
  GEMM (`torch.matmul`) multiplies them, and the product is carved back
  into C's full block pattern (`_dense_multiply`, with the general,
  chunked and uniform paths of the JAX package);
* composite: row panels with narrow k-support packed into one batched
  GEMM (`_composite_multiply`).

Accumulation order is fixed by the sort and the kernel's per-run loop,
so a stack run reproduces its checksums bit for bit.  Filtering follows
the reference (`dbcsr_mm.F:360-369`): skip a product when
||A_ik||^2 * ||B_kj||^2 < (eps / max(1, nblks in A's row i))^2 in single
precision, then drop C blocks with ||C||^2 < eps^2 unless
``retain_sparsity``.  A symmetric operand is desymmetrized; a symmetric
C keeps only its stored triangle's (i <= j) products.  Block limits and
element limits restrict the product, and beta then scales C only inside
the limited window (ref the windowed dgemm, `dbcsr_test_multiply.F:631-633`).

Plan cache (ref `dbcsr_tpu/mm/multiply.py:290-329,1708-1870`): the
spans of a stack product are kept under a key of the operands' pattern
fingerprints, dtypes, device, C's kind, ``retain_sparsity``, the limits,
the config fields planning reads and the tuned table's path and
generation; a filtered product adds its eps and a digest of the
surviving candidates (only while `core.mempool.enabled`).  A repeat of
a same-pattern product still computes its candidates and rebuilds C,
but skips the group sort and the uploads of `prepare_stack`.  Plans
hold int32 device indices only, never a bin, and first-use validation
stays keyed by kernel shape in `acc/smm.py`.  LRU of 16 entries and 256
MiB of index bytes.

Integrity (ref `dbcsr_tpu/mm/multiply.py:246-270,512-535,1891-2025`):
each multiply opens an event-bus product and a flight record
(`obs.events.product_scope`).  The dense and composite formats have the
``dense`` fault site and `_dense_guard` (the corruption hook, the opt-in
finite check) before their result reaches C, and the ABFT canvas probe
while ``abft`` is on; a canvas failure falls over to the stack format
while C still holds the bins it held (`_note_dense_fallback` counts it).
A beta = 0 stack product defers its launches' ABFT probes to one flush
at its end; a mismatch there zeroes C's bins and redoes the product with
immediate checks (`_run_stacks`).

Precision and reuse (ref `dbcsr_tpu/mm/multiply.py:290-375`): the plan
key carries `acc.precision.plan_token`, so a promotion or a chain
scope's transition never reuses a demoted plan.  An eligible product
(stack format, beta = 0, unfiltered, unlimited, non-symmetric C, plan
cacheable) first asks `mm.incremental.maybe_reuse`, which may splice C
from the cached result of the same product; after a full run,
`note_executed` records it.  A canvas format drops the entries of its
operands (`note_format_executed`).  Complex kinds multiply on every
format; "C" conjugates the transposed operand, and complex alpha and
beta need a complex C.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from dbcsr_tpu_torch import native
from dbcsr_tpu_torch.acc import abft, params
from dbcsr_tpu_torch.acc import precision as _precision
from dbcsr_tpu_torch.acc import smm as _smm
from dbcsr_tpu_torch.acc.smm import StackPlan, execute_stack, prepare_stack
from dbcsr_tpu_torch.core import digests, mempool
from dbcsr_tpu_torch.core.config import get_config
from dbcsr_tpu_torch.core.kinds import name_of
from dbcsr_tpu_torch.core.matrix import (
    NO_SYMMETRY,
    BlockSparseMatrix,
    _Bin,
    _bin_entries,
    move_blocks,
    to_index,
)
from dbcsr_tpu_torch.mm import format_planner
from dbcsr_tpu_torch.mm import incremental as _incremental
from dbcsr_tpu_torch.obs import events, flight
from dbcsr_tpu_torch.ops.operations import compress, crop_matrix, window_mask
from dbcsr_tpu_torch.ops.transformations import desymmetrize, new_transposed
from dbcsr_tpu_torch.resilience import faults

NO_LIMITS = (None,) * 6

_PLAN_CACHE_MAX = 16
_PLAN_CACHE_MAX_BYTES = 256 * 1024 * 1024
_plan_cache: "OrderedDict[tuple, _CachedSpans]" = OrderedDict()
_plan_cache_bytes = 0

# what every multiply since `reset_totals` did: the count, host seconds
# per phase, plan-cache outcomes, format decisions, the engine that ran
# each expansion and sort, the longest run of any stack, the device
# seconds per format already read from their CUDA event pairs, and the
# pairs still pending
_totals: dict = {}


def reset_totals() -> None:
    _totals.update(multiplies=0, host_phase_s={}, longest_run=0, device_s={}, timed={},
                   events=[], plan_cache={"hit": 0, "miss": 0, "uncacheable": 0}, reused=0,
                   formats={}, index_engine={"expand": {"native": 0, "numpy": 0},
                                             "sort": {"native": 0, "numpy": 0}})


reset_totals()


def _fold_events(wait: bool) -> None:
    """Move finished event pairs into ``device_s`` (all of them, after a
    synchronize, when ``wait``), so the pending list stays short however
    many multiplies run between two reads."""
    pending = _totals["events"]
    if wait and pending:
        torch.cuda.synchronize()
    while pending and (wait or pending[0][2].query()):
        fmt, e0, e1 = pending.pop(0)
        _totals["device_s"][fmt] = _totals["device_s"].get(fmt, 0.0) + e0.elapsed_time(e1) / 1e3


def read_totals() -> dict:
    """The totals since `reset_totals`: ``multiplies``, ``host_phase_s``
    (summed per phase), ``plan_cache`` outcome counts, ``reused`` (the
    products `mm.incremental` served from its cache), ``formats`` (the
    planner's decisions as "format:reason" counts), ``index_engine`` (how
    many expansions and sorts ran "native" or "numpy"), ``longest_run``,
    ``device_s`` (CUDA-event seconds of each format's device work, summed
    over the multiplies) and ``stack_device_s``, its stack share (None
    without events).  Synchronizes."""
    _fold_events(wait=True)
    return {"multiplies": _totals["multiplies"],
            "host_phase_s": dict(_totals["host_phase_s"]),
            "plan_cache": dict(_totals["plan_cache"]), "reused": _totals["reused"],
            "formats": dict(_totals["formats"]),
            "index_engine": {k: dict(v) for k, v in _totals["index_engine"].items()},
            "longest_run": _totals["longest_run"],
            "device_s": dict(_totals["device_s"]),
            "stack_device_s": (_totals["device_s"].get("stack", 0.0)
                               if _totals["timed"].get("stack") else None)}


def clear_plan_cache() -> None:
    global _plan_cache_bytes
    _plan_cache.clear()
    _plan_cache_bytes = 0


def _real_scalar(x, dtype):
    """Coerce alpha/beta for a product into C of ``dtype``: a complex for
    a complex C; for a real C a nonzero imaginary part raises a clear
    TypeError."""
    arr = np.asarray(x)
    if dtype.is_complex:
        return complex(arr)
    if np.iscomplexobj(arr):
        if complex(arr).imag != 0.0:
            raise TypeError(
                f"complex alpha/beta with a real matrix C (dtype {dtype}); "
                f"use a complex matrix or real scalars")
        return complex(arr).real
    return float(x)


def _effective(matrix: BlockSparseMatrix, trans: str) -> BlockSparseMatrix:
    """Resolve op(X): desymmetrize, then transpose, conjugated for "C" on
    a complex kind (ref transpose wrappers at `dbcsr_mm.F:521-582`)."""
    trans = trans.upper()
    if trans not in ("N", "T", "C"):
        raise ValueError(f"bad trans flag {trans!r}")
    m = desymmetrize(matrix) if matrix.matrix_type != NO_SYMMETRY else matrix
    if trans == "N":
        return m
    return new_transposed(m, conjugate=trans == "C" and m.dtype.is_complex)


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
    true flop count.

    The first/last row/col/k limits restrict the product to a block
    submatrix (0-based, inclusive).  ``element_limits`` gives them at
    element granularity instead, as a 6-tuple (first_row, last_row,
    first_col, last_col, first_k, last_k) of 0-based inclusive element
    indices (None = open): limits off the block boundaries are honoured
    exactly by cropping op(A) and op(B) (ref `dbcsr_crop_matrix` in
    `make_m2s`, `dbcsr_mm_cannon.F:194-220`).  With row or column limits,
    beta scales C only inside the window; C outside keeps its values."""
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

    limits = (first_row, last_row, first_col, last_col, first_k, last_k)
    beta_window = None
    if element_limits is not None:
        if any(x is not None for x in limits):
            raise ValueError("give block-index OR element limits, not both")
        a, b, limits, beta_window = _apply_element_limits(a, b, c, element_limits)
    elif any(x is not None for x in limits[:4]):
        # the windowed beta of block limits: the window's element bounds
        roff, coff = c.row_blk_offsets, c.col_blk_offsets
        beta_window = (
            int(roff[first_row]) if first_row is not None else 0,
            int(roff[last_row + 1]) - 1 if last_row is not None else c.nfullrows - 1,
            int(coff[first_col]) if first_col is not None else 0,
            int(coff[last_col + 1]) - 1 if last_col is not None else c.nfullcols - 1,
        )
    with events.product_scope("multiply", c.name, m=c.nfullrows, n=c.nfullcols,
                              k=a.nfullcols, filter_eps=filter_eps,
                              retain_sparsity=retain_sparsity):
        flops = _multiply_body(a, b, c, alpha, beta, retain_sparsity, filter_eps, limits,
                               beta_window)
        flight.note("flops", flops)
        flight.note("algorithm", c._mm_algorithm)
        flight.note("phases_ms", {k: round(v * 1e3, 3) for k, v in c._mm_phase_s.items()})
    return flops


def _multiply_body(a, b, c, alpha, beta, retain_sparsity, filter_eps, limits,
                   beta_window) -> int:
    """The engine body.  Leaves the format in ``c._mm_algorithm``, the
    host seconds of each phase in ``c._mm_phase_s`` ("format" for the
    planner; "index", "assemble", "plan" -- the plan-cache lookup
    included -- and "launch" for a stack product; "dense" or "composite"
    for the calls of those formats), the plan-cache outcome in
    ``c._mm_plan_cache`` (None off the stack format), each span's (m, n,
    k, entries, kernel, longest run) in ``c._mm_spans`` and, on a CUDA
    device, a pair of CUDA events around the format's device work in
    ``c._mm_device_events``."""
    t0 = time.perf_counter()
    plan = format_planner.choose(a, b, c, filter_eps=filter_eps,
                                 retain_sparsity=retain_sparsity,
                                 no_limits=all(x is None for x in limits))
    phase = {"format": time.perf_counter() - t0}
    flops = None
    if plan.fmt != "stack":
        flops = _canvas_multiply(a, b, c, alpha, beta, plan, phase)
    c._mm_algorithm = plan.fmt if flops is not None else "stack"
    if flops is None:
        flops = _stack_multiply(a, b, c, alpha, beta, retain_sparsity, filter_eps, limits,
                                beta_window, phase)
    c._mm_phase_s = phase
    _totals["multiplies"] += 1
    decision = f"{plan.fmt}:{plan.reason}"
    _totals["formats"][decision] = _totals["formats"].get(decision, 0) + 1
    for name, sec in phase.items():
        _totals["host_phase_s"][name] = _totals["host_phase_s"].get(name, 0.0) + sec
    if c._mm_device_events is not None:
        fmt = c._mm_algorithm
        _totals["timed"][fmt] = _totals["timed"].get(fmt, 0) + 1
        _totals["events"].append((fmt, *c._mm_device_events))
        _fold_events(wait=False)
    return int(flops)


def _canvas_multiply(a, b, c, alpha, beta, plan, phase):
    """The dense or composite format; None when it failed while C still
    held its bins, so the caller runs the stack format instead (the
    canvas paths and the stack format compute the same product, and the
    canvas paths install C's new bins last)."""
    # a float32 GEMM under TF32 is the caller's setting to fix, not a
    # failure to fall over from
    _check_matmul_precision(c.dtype, c.device)
    held = [(bn.data, bn.data._version) for bn in c.bins]
    t1 = time.perf_counter()
    ev = _start_events(c.device)
    try:
        if plan.fmt == "composite":
            flops = _composite_multiply(a, b, c, alpha, beta, plan.panels)
        else:
            flops = _dense_multiply(a, b, c, alpha, beta)
    except Exception as exc:  # noqa: BLE001 -- classified and counted, or raised
        if len(c.bins) != len(held) or any(bn.data is not d or bn.data._version != v
                                           for bn, (d, v) in zip(c.bins, held)):
            raise  # C already restructured: nothing to fall over from
        _note_dense_fallback(exc, driver=plan.fmt)
        return None
    c._mm_device_events = _stop_events(ev)
    phase[plan.fmt] = time.perf_counter() - t1
    c._mm_plan_cache = None
    c._mm_spans = []
    # the canvas restructured C: cached results of these operands can
    # never be spliced into it again
    _incremental.note_format_executed(a, b)
    return flops


def _note_dense_fallback(exc: BaseException, driver: str = "dense") -> None:
    """Count a canvas-to-stack failover with the stack chain's counters
    and events (ref `dbcsr_tpu/mm/multiply.py:512-526`); a canvas
    condemned by its probe counts as recovered, since the stack format
    recomputes the product from an untouched C."""
    kind = _smm._classify_failure(exc)
    _smm._record_driver_failure(driver, kind, exc, ())
    _smm._record_fallback(driver, "stack", ())
    if kind == "sdc":
        abft.record_recovery(driver)
    flight.note("dense_fallback", f"{type(exc).__name__}: {exc}"[:200])


def _dense_guard(x: torch.Tensor) -> torch.Tensor:
    """The ``dense`` corruption hook and the opt-in finite check on a
    canvas format's result, before it reaches C (ref
    `dbcsr_tpu/mm/multiply.py:527-535`)."""
    if faults.active():
        faults.corrupt("dense", x)
    if _smm._output_checks_enabled() and _smm._output_corrupted(x):
        raise _smm.CorruptedOutputError("dense path produced non-finite output")
    return x


def _start_events(device: torch.device):
    if device.type != "cuda":
        return None
    events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    events[0].record()
    return events


def _stop_events(events):
    if events is not None:
        events[1].record()
    return events


def _stack_multiply(a, b, c, alpha, beta, retain_sparsity, filter_eps, limits,
                    beta_window, phase) -> int:
    """The stack format: index, the incremental reuse where eligible,
    assemble, plan (or the cached plan) and launch, then the filter's
    compress."""
    t0 = time.perf_counter()
    i, j, a_ent, b_ent = _candidates(a, b, filter_eps, sym_c=c.matrix_type != NO_SYMMETRY,
                                     limits=limits)
    old_keys = c.keys
    old_fp = c.pattern_fingerprint()
    cand_keys = i * c.nblkcols + j
    if retain_sparsity:
        ok = mask_in_sorted(cand_keys, old_keys)
        cand_keys, a_ent, b_ent = cand_keys[ok], a_ent[ok], b_ent[ok]
        new_keys = old_keys
    else:
        new_keys = np.union1d(old_keys, np.unique(cand_keys))
    key = _plan_key(a, b, c, old_fp, retain_sparsity, filter_eps, limits, cand_keys, a_ent,
                    b_ent)
    t1 = time.perf_counter()
    phase["index"] = t1 - t0
    inc_eligible = (key is not None and filter_eps is None and beta == 0
                    and beta_window is None and not retain_sparsity
                    and all(x is None for x in limits) and mempool.enabled()
                    and c.matrix_type == NO_SYMMETRY)
    c._mm_device_events, c._mm_spans = None, []
    if inc_eligible:
        flops = _incremental.maybe_reuse(key, a, b, c, alpha, new_keys, cand_keys, a_ent, b_ent)
        if flops is not None:
            c._note_mutation(c.keys)  # the spliced values are installed
            phase["incremental"] = time.perf_counter() - t1
            c._mm_plan_cache = None
            _totals["reused"] += 1
            return flops
        t_inc = time.perf_counter()
        phase["incremental"] = t_inc - t1  # what deciding on a full run cost
        t1 = t_inc
    _rebuild_c(c, new_keys, beta, beta_window)
    t2 = time.perf_counter()
    phase["assemble"] = t2 - t1
    spans, c._mm_plan_cache = _spans_for(key, c, a, b, cand_keys, a_ent, b_ent)
    t3 = time.perf_counter()
    phase["plan"] = t3 - t2
    flops = _run_stacks(c, a, b, spans, alpha, c_zero=beta == 0 and beta_window is None)
    phase["launch"] = time.perf_counter() - t3
    # the kernels wrote C's bins in place: stamp the completed values
    c._note_mutation(c.keys)
    if inc_eligible:
        demoted = {sp.plan.precision for sp in spans if sp.plan.precision is not None}
        _incremental.note_executed(key, a, b, c, alpha, demoted,
                                   phase["assemble"] + phase["plan"] + phase["launch"])
    if filter_eps is not None and not retain_sparsity:
        norms = c.block_norms()
        compress(c, norms ** 2 >= float(filter_eps) ** 2)
    _totals["plan_cache"][c._mm_plan_cache] += 1
    return flops


def _spans_for(key, c, a, b, cand_keys, a_ent, b_ent):
    """The product's spans from the plan cache under ``key``, or built
    and inserted (C already assembled), with the outcome ("hit", "miss",
    "uncacheable"); records them in ``c._mm_spans`` and the longest run
    in the totals."""
    spans = _cached_spans(key)
    outcome = "uncacheable" if key is None else "hit" if spans is not None else "miss"
    if spans is None:
        spans = _build_spans(c, a, b, cand_keys, a_ent, b_ent)
        if key is not None:
            _plan_cache_insert(key, spans)
    c._mm_spans = [(sp.m, sp.n, sp.k, sp.entries, sp.driver, sp.plan.max_run) for sp in spans]
    _totals["longest_run"] = max([_totals["longest_run"]] + [sp.plan.max_run for sp in spans])
    return spans, outcome


def _plan_key(a, b, c, c_fp, retain_sparsity, filter_eps, limits, cand_keys, a_ent, b_ent):
    """The plan-cache key (ref `dbcsr_tpu/mm/multiply.py:299-329`), or
    None for a filtered product while `mempool.enabled` is off.  ``c_fp``
    is C's fingerprint before `_rebuild_c`.  The port's additions: the
    device (planning asks whether C is on the card) and the tuned
    table's path (a redirected table directory)."""
    if filter_eps is not None and not mempool.enabled():
        return None
    cfg = get_config()
    key = (a.pattern_fingerprint(), b.pattern_fingerprint(), c_fp,
           name_of(a.dtype), name_of(b.dtype), name_of(c.dtype), str(c.device),
           c.matrix_type, bool(retain_sparsity), tuple(limits),
           (cfg.mm_driver, cfg.validate_kernels, cfg.mm_format),
           params.params_path(), params.generation(),
           # an adaptive promotion or a chain scope's transition must not
           # be served a demoted plan
           _precision.plan_token())
    if filter_eps is not None:
        key += ("filtered", float(filter_eps), digests.index_digest(cand_keys, a_ent, b_ent))
    return key


class _CachedSpans(NamedTuple):
    spans: list
    nbytes: int


def _cached_spans(key):
    """The cached spans of ``key`` (refreshed as most recent), or None."""
    if key is None or key not in _plan_cache:
        return None
    _plan_cache.move_to_end(key)
    return _plan_cache[key].spans


def _plan_cache_insert(key, spans) -> None:
    """Insert with LRU eviction by entry count and by the index bytes
    the cached plans pin (ref `dbcsr_tpu/mm/multiply.py:1760-1777`)."""
    global _plan_cache_bytes
    old = _plan_cache.pop(key, None)
    if old is not None:
        _plan_cache_bytes -= old.nbytes
    entry = _CachedSpans(spans, sum(sp.plan.nbytes() for sp in spans))
    _plan_cache[key] = entry
    _plan_cache_bytes += entry.nbytes
    while len(_plan_cache) > _PLAN_CACHE_MAX or (
            len(_plan_cache) > 1 and _plan_cache_bytes > _PLAN_CACHE_MAX_BYTES):
        _, evicted = _plan_cache.popitem(last=False)
        _plan_cache_bytes -= evicted.nbytes


def mask_in_sorted(cand_keys: np.ndarray, sorted_keys: np.ndarray) -> np.ndarray:
    """Membership of each cand_key in sorted_keys (retain_sparsity)."""
    if len(sorted_keys) == 0:
        return np.zeros(len(cand_keys), bool)
    pos = np.searchsorted(sorted_keys, cand_keys)
    return (pos < len(sorted_keys)) & (
        sorted_keys[np.minimum(pos, len(sorted_keys) - 1)] == cand_keys)


# ------------------------------------------------------------------ limits
def _apply_element_limits(a, b, c, element_limits):
    """Resolve element limits (ref `dbcsr_multiply`'s full-index limit
    arguments): block-aligned limits reduce to block limits; unaligned
    ones also crop op(A) and op(B) at element level (ref
    `dbcsr_crop_matrix` in `make_m2s`, `dbcsr_mm_cannon.F:194-220`), so a
    boundary block contributes only its in-window elements.  Returns
    (a, b, block limits, beta window)."""
    if len(element_limits) != 6:
        raise ValueError("element_limits must be a 6-tuple")
    fr, lr, fc, lc, fk, lk = element_limits
    fr = 0 if fr is None else int(fr)
    lr = c.nfullrows - 1 if lr is None else int(lr)
    fc = 0 if fc is None else int(fc)
    lc = c.nfullcols - 1 if lc is None else int(lc)
    fk = 0 if fk is None else int(fk)
    lk = a.nfullcols - 1 if lk is None else int(lk)
    if not (0 <= fr <= lr < c.nfullrows and 0 <= fc <= lc < c.nfullcols
            and 0 <= fk <= lk < a.nfullcols):
        raise ValueError(f"element limits out of range: {element_limits}")

    def axis(lo, hi, off, n_el):
        b0 = int(np.searchsorted(off, lo, side="right") - 1)
        b1 = int(np.searchsorted(off, hi, side="right") - 1)
        aligned = off[b0] == lo and off[b1 + 1] - 1 == hi
        return b0, b1, aligned, lo == 0 and hi == n_el - 1

    rb0, rb1, r_al, r_full = axis(fr, lr, c.row_blk_offsets, c.nfullrows)
    cb0, cb1, c_al, c_full = axis(fc, lc, c.col_blk_offsets, c.nfullcols)
    kb0, kb1, k_al, k_full = axis(fk, lk, a.col_blk_offsets, a.nfullcols)
    if not (r_al and c_al and k_al):
        a = crop_matrix(a, row_bounds=(fr, lr), col_bounds=(fk, lk))
        b = crop_matrix(b, row_bounds=(fk, lk), col_bounds=(fc, lc))
    block_limits = (None if r_full else rb0, None if r_full else rb1,
                    None if c_full else cb0, None if c_full else cb1,
                    None if k_full else kb0, None if k_full else kb1)
    beta_window = None if (r_full and c_full) else (fr, lr, fc, lc)
    return a, b, block_limits, beta_window


# ------------------------------------------------------------ stack format
def _candidates(a, b, filter_eps, sym_c: bool = False, limits=NO_LIMITS):
    """Symbolic product with the reference's on-the-fly norm filter:
    squared f32 norms and a per-A-row eps (`dbcsr_mm_cannon.F:1098-1105`);
    ``sym_c`` keeps only C's stored triangle, i <= j (ref the symmetric
    skip, `dbcsr_mm_csr.F:281`); ``limits`` are the block limits.  Runs
    the native engine unless `native.enabled` is off."""
    na2 = nb2 = row_eps = None
    if filter_eps is not None:
        na2 = a.block_norms().astype(np.float32) ** 2
        nb2 = b.block_norms().astype(np.float32) ** 2
        row_counts = np.diff(a.row_ptr)
        with np.errstate(over="ignore"):  # huge eps -> inf is a valid threshold
            row_eps = (np.float32(filter_eps)
                       / np.maximum(1, row_counts).astype(np.float32)) ** 2
    if native.enabled():
        _totals["index_engine"]["expand"]["native"] += 1
        return native.symbolic_product(a.row_ptr, a.keys % a.nblkcols, b.row_ptr,
                                       b.keys % b.nblkcols, na2, nb2, row_eps,
                                       sym_c=sym_c, limits=limits)
    _totals["index_engine"]["expand"]["numpy"] += 1
    return _candidates_numpy(a, b, na2, nb2, row_eps, sym_c, limits)


def _candidates_numpy(a, b, na2, nb2, row_eps, sym_c: bool = False, limits=NO_LIMITS):
    """All (i, k, j) triples of op(A) * op(B) as parallel arrays
    (i, j, a_ent, b_ent): a_ent indexes A's entries, b_ent B's."""
    fr, lr, fc, lc, fk, lk = limits
    rows_a = np.repeat(np.arange(a.nblkrows, dtype=np.int64), np.diff(a.row_ptr))
    cols_a = (a.keys % a.nblkcols).astype(np.int64)  # k per A entry
    cols_b = (b.keys % b.nblkcols).astype(np.int64)  # j per B entry
    a_sel = np.ones(len(a.keys), bool)
    for x, lo, hi in ((rows_a, fr, lr), (cols_a, fk, lk)):
        if lo is not None:
            a_sel &= x >= lo
        if hi is not None:
            a_sel &= x <= hi
    a_entries = np.nonzero(a_sel)[0]
    k_of = cols_a[a_entries]
    counts = (b.row_ptr[k_of + 1] - b.row_ptr[k_of]).astype(np.int64)
    tot = int(counts.sum())
    if tot == 0:
        z = np.empty(0, np.int64)
        return z, z, z, z
    a_ent = np.repeat(a_entries, counts)
    starts = np.cumsum(counts) - counts
    b_ent = (np.arange(tot, dtype=np.int64) - np.repeat(starts, counts)
             + np.repeat(b.row_ptr[k_of], counts))
    i = rows_a[a_ent]
    j = cols_b[b_ent]
    keep = np.ones(tot, bool)
    if fc is not None:
        keep &= j >= fc
    if lc is not None:
        keep &= j <= lc
    if sym_c:
        keep &= i <= j
    if na2 is not None:
        keep &= na2[a_ent] * nb2[b_ent] >= row_eps[i]
    if not keep.all():
        i, j, a_ent, b_ent = i[keep], j[keep], a_ent[keep], b_ent[keep]
    return i, j, a_ent, b_ent


def _rebuild_c(c: BlockSparseMatrix, new_keys: np.ndarray, beta, beta_window=None) -> None:
    """Restructure C onto the (possibly grown) pattern on the device: new
    blocks zero, old blocks scaled by beta.  With ``beta_window`` = (r0,
    r1, c0, c1), inclusive element bounds, beta applies only inside the
    window: old blocks wholly outside are copied as they are, and blocks
    straddling it get an element-masked scale."""
    old_keys, old_bins = c.keys, c.bins
    old_ent_bin, old_ent_slot = c.ent_bin, c.ent_slot
    rows = (new_keys // c.nblkcols).astype(np.int64)
    cols = (new_keys % c.nblkcols).astype(np.int64)
    nb, nsl, shapes = _bin_entries(c.row_blk_sizes, c.col_blk_sizes, rows, cols)
    pos_old = np.searchsorted(new_keys, old_keys)  # old keys are in new keys
    n_old = len(old_keys)
    dev = c.device
    windowed = beta_window is not None and beta != 1 and n_old > 0
    inside = np.ones(n_old, bool)
    straddle = np.zeros(n_old, bool)
    if windowed:
        r0, r1, c0, c1 = beta_window
        orows = (old_keys // c.nblkcols).astype(np.int64)
        ocols = (old_keys % c.nblkcols).astype(np.int64)
        blk_r0 = c.row_blk_offsets[orows]
        blk_r1 = c.row_blk_offsets[orows + 1] - 1
        blk_c0 = c.col_blk_offsets[ocols]
        blk_c1 = c.col_blk_offsets[ocols + 1] - 1
        overlap = (blk_r1 >= r0) & (blk_r0 <= r1) & (blk_c1 >= c0) & (blk_c0 <= c1)
        inside = overlap & (blk_r0 >= r0) & (blk_r1 <= r1) & (blk_c0 >= c0) & (blk_c1 <= c1)
        straddle = overlap & ~inside
    counts = np.bincount(nb, minlength=len(shapes))
    bins = []
    for b_id, (bm, bn) in enumerate(shapes):
        data = torch.zeros((int(counts[b_id]), bm, bn), dtype=c.dtype, device=dev)
        in_bin = nb[pos_old] == b_id if n_old else np.zeros(0, bool)

        def move(mask, factor=None):
            """Copy the old blocks of ``mask`` to their new slots (times
            ``factor``), a bounded chunk at a time; returns them, or None."""
            sel = np.nonzero(mask)[0]
            if len(sel):
                move_blocks(data, nsl[pos_old[sel]], old_bins[old_ent_bin[sel[0]]].data,
                            old_ent_slot[sel], factor)
            return sel if len(sel) else None

        if beta != 0:
            move(in_bin & inside, None if beta == 1 else beta)
        if windowed:
            move(in_bin & ~inside & ~straddle)
            if (sel := move(in_bin & straddle)) is not None:
                lo_hi = (np.maximum(r0 - blk_r0[sel], 0), np.minimum(r1 - blk_r0[sel], bm - 1),
                         np.maximum(c0 - blk_c0[sel], 0), np.minimum(c1 - blk_c0[sel], bn - 1))
                mask = window_mask(bm, bn, *(to_index(x, dev) for x in lo_hi))
                one = torch.ones((), dtype=c.dtype, device=dev)
                slots = to_index(nsl[pos_old[sel]], dev)
                data[slots] = data[slots] * torch.where(mask, beta * one, one)
        bins.append(_Bin((bm, bn), data, int(counts[b_id])))
    c.set_structure_from_device(new_keys, bins, binning=(nb, nsl, shapes))


class Span(NamedTuple):
    """One stack of the product: the bins it reads and writes, its block
    shape, its entry count and its prepared plan."""

    cbin: int
    abin: int
    bbin: int
    m: int
    n: int
    k: int
    entries: int
    plan: StackPlan

    @property
    def driver(self) -> str:
        """The kernel the plan launches (`StackPlan.kernel`; a failover
        heals the plan, and this follows it)."""
        return self.plan.kernel


def _sort_order(group, ngroups: int, c_slot, a_ent):
    """The stack order by (group, C slot, A entry) and the ``ngroups`` + 1
    group boundaries: the native engine's, or `np.lexsort`'s when
    `native.enabled` is off (identical, as no two entries tie)."""
    if native.enabled():
        _totals["index_engine"]["sort"]["native"] += 1
        return native.group_sort_stacks(group, ngroups, c_slot, a_ent)
    _totals["index_engine"]["sort"]["numpy"] += 1
    order = np.lexsort((a_ent, c_slot, group))
    bounds = np.concatenate([[0], np.cumsum(np.bincount(group, minlength=ngroups))])
    return order, bounds


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
    order, bounds = _sort_order(g, len(c.bins) * len(a.bins) * len(b.bins), c_slot, a_ent)
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
        spans.append(Span(cbin, abin, bbin, m, n, k, s1 - s0, plan))
    return spans


def _run_stacks(c, a, b, spans, alpha, c_zero: bool = False) -> int:
    """Execute the prepared spans in order, in place on C's bins; returns
    the true flops.  ``c_zero``: every C bin is zero (beta = 0, no
    window), so each bin's first span needs no pristine copy, and under
    ABFT the product defers those spans' probes to one `abft.flush`; a
    mismatch there zeroes every bin and redoes the product with immediate
    checks, where the stack failover localizes and heals it (ref
    `dbcsr_tpu/mm/multiply.py:1891,1988-2025`)."""

    def exec_spans(defer: bool) -> int:
        zero_bins = set(range(len(c.bins))) if c_zero else set()
        flops = 0
        for sp in spans:
            execute_stack(c.bins[sp.cbin].data, a.bins[sp.abin].data,
                          b.bins[sp.bbin].data, sp.plan, alpha,
                          c_zero=sp.cbin in zero_bins, abft_defer=defer)
            zero_bins.discard(sp.cbin)
            flops += 2 * sp.m * sp.n * sp.k * sp.entries
        return flops

    ev = _start_events(c.device) if spans else None
    recovered_from = []
    for attempt in (0, 1):
        defer = c_zero and abft.enabled() and attempt == 0
        if defer:
            abft.discard_pending()
        try:
            flops = exec_spans(defer)
        except BaseException:
            if defer:  # an aborted product's probes are charged to no later one
                abft.discard_pending()
            raise
        if not defer:
            break
        try:
            abft.flush()
            break
        except abft.AbftMismatchError as exc:
            # a demoted launch's breach is a promote, not corruption: no
            # breaker feed, no recovery; the redo's immediate checks
            # re-execute each still-demoted plan natively
            if not isinstance(exc, abft.PrecisionExceededError):
                _smm.note_deferred_sdc(exc)
                recovered_from = exc.mismatch_drivers
            for bin_ in c.bins:
                bin_.data.zero_()
    for drv in recovered_from:
        abft.record_recovery(drv)
    c._mm_device_events = _stop_events(ev)
    return flops


# ------------------------------------------------------------ dense format
# canvases beyond this element count make the dense path chunk (the JAX
# package's cap, kept so both packages decide alike)
_DENSE_MAX_CANVAS = 2 * 10**8


def _uniform(m: BlockSparseMatrix) -> bool:
    return len(np.unique(m.row_blk_sizes)) == 1 and len(np.unique(m.col_blk_sizes)) == 1


def _near_uniform(sizes) -> bool:
    """All block sizes equal except a possibly smaller last one, as every
    ceil-division blocking (`perf.driver.expand_block_sizes`) gives."""
    if len(sizes) == 0:
        return False
    s0 = int(sizes[0])
    return bool(np.all(np.asarray(sizes[:-1]) == s0) and int(sizes[-1]) <= s0)


def _true_product_flops(a, b) -> int:
    """Exact flops of the block-sparse product without enumerating the
    triples: sum_k 2 * W_m(k) * W_n(k) * k_k, with W_m(k) the row extent
    of A's stored blocks in block column k and W_n(k) the column extent
    of B's stored blocks in block row k (the 'true flops' of
    `dbcsr_mm.F:664-667`)."""
    if a.nblks == 0 or b.nblks == 0:
        return 0
    ar, ac = a.entry_coords()
    br, bc = b.entry_coords()
    wa = np.bincount(ac, weights=a.row_blk_sizes[ar].astype(np.float64), minlength=a.nblkcols)
    wb = np.bincount(br, weights=b.col_blk_sizes[bc].astype(np.float64), minlength=b.nblkrows)
    kk = a.col_blk_sizes.astype(np.float64)
    return int(round(2.0 * float(np.dot(wa * kk, wb))))


def _dense_chunking(nbr, nbc, nbk, bm, bn, bk):
    """(block rows per m-strip, k block columns per k-strip, block columns
    per n-strip) so every strip canvas (A: m-strip x k-strip, B: k-strip
    x n-strip, C: m-strip x n-strip) fits `_DENSE_MAX_CANVAS` elements,
    or None when not even single-block strips fit."""
    cap = _DENSE_MAX_CANVAS
    ncb = nbc
    if bm * nbc * bn > cap:
        ncb = min(nbc, max(1, cap // (bm * bn)))
    n_el = ncb * bn
    mrb = min(nbr, max(1, cap // (bm * n_el)))
    kcb = min(nbk, max(1, cap // (bk * max(mrb * bm, n_el))))
    if (mrb * bm) * (kcb * bk) > cap or (kcb * bk) * n_el > cap \
            or (mrb * bm) * n_el > cap:
        return None
    return mrb, kcb, ncb


def _dense_mode_wanted(a, b, c, filter_eps, retain_sparsity, no_limits) -> bool:
    """The dense-mode decision (ref `dbcsr_mm.F:593-617`): an unfiltered,
    unlimited product into a non-symmetric C goes dense when forced
    (``mm_dense=True``) or when both operands are at least
    ``dense_occ_threshold`` full.  The JAX package's flop-ratio model
    for the dtypes a TPU emulates (`dbcsr_tpu/mm/multiply.py:469-509`)
    has no counterpart: the H100 emulates none."""
    cfg = get_config()
    if cfg.mm_dense is False or cfg.mm_driver == "pallas":
        return False
    if filter_eps is not None or retain_sparsity or not no_limits:
        return False
    if c.matrix_type != NO_SYMMETRY:
        return False
    if cfg.mm_dense is True:
        return True
    th = cfg.dense_occ_threshold
    return a.occupation() >= th and b.occupation() >= th


def _check_matmul_precision(dtype: torch.dtype, device: torch.device) -> None:
    """The JAX package multiplies its canvases at ``Precision.HIGHEST``:
    a float32 canvas GEMM on the card must not run as TF32 (the global
    switches are the caller's, so this raises rather than changes them)."""
    if device.type == "cuda" and dtype in (torch.float32, torch.complex64) and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "dense/composite float32 and complex64 products need full float32 GEMMs: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def _scatter_blocks(canvas: torch.Tensor, blocks: torch.Tensor, ro, co) -> None:
    """Write (N, bm, bn) ``blocks`` into ``canvas`` at element offsets
    (ro[s], co[s]): one indexed write (the make_dense data movement)."""
    dev = canvas.device
    bm, bn = blocks.shape[1], blocks.shape[2]
    r = to_index(ro, dev)[:, None, None] + torch.arange(bm, device=dev)[None, :, None]
    col = to_index(co, dev)[:, None, None] + torch.arange(bn, device=dev)[None, None, :]
    canvas[r, col] = blocks


def _gather_blocks(canvas: torch.Tensor, ro, co, bm: int, bn: int) -> torch.Tensor:
    """(N, bm, bn) patches of ``canvas`` at element offsets (ro, co)."""
    dev = canvas.device
    r = to_index(ro, dev)[:, None, None] + torch.arange(bm, device=dev)[None, :, None]
    col = to_index(co, dev)[:, None, None] + torch.arange(bn, device=dev)[None, None, :]
    return canvas[r, col]


def _to_dense_device(m: BlockSparseMatrix) -> torch.Tensor:
    """``m`` as a dense canvas on its device (any blocking), one indexed
    write per shape bin."""
    canvas = torch.zeros((m.nfullrows, m.nfullcols), dtype=m.dtype, device=m.device)
    if m.nblks == 0:
        return canvas
    rows, cols = m.entry_coords()
    roff = m.row_blk_offsets[rows]
    coff = m.col_blk_offsets[cols]
    for b_id, b in enumerate(m.bins):
        sel = np.nonzero(m.ent_bin == b_id)[0]
        ro = np.empty(b.count, np.int64)
        co = np.empty(b.count, np.int64)
        ro[m.ent_slot[sel]] = roff[sel]
        co[m.ent_slot[sel]] = coff[sel]
        _scatter_blocks(canvas, b.data, ro, co)
    return canvas


def _dense_canvas_cached(m: BlockSparseMatrix) -> torch.Tensor:
    """`_to_dense_device` of ``m``, cached on the matrix under the
    identity of its index arrays and bins and each bin's version counter
    (every in-place write by a torch op bumps it, and so does every
    kernel wrapper that writes a bin through its raw pointer,
    `acc.stack_kernel.mark_written`; the cache holds the tensors, so an
    identity cannot be reused): a repeat with unchanged operands skips
    the scatter.  Structure changes and `free` drop it.  Callers never
    write into the canvas."""
    held = (m.keys, m.ent_bin, m.ent_slot, *(b.data for b in m.bins))
    versions = tuple(b.data._version for b in m.bins)
    cache = m._dense_canvas
    if (cache is not None and len(cache[0]) == len(held) and cache[1] == versions
            and all(x is y for x, y in zip(cache[0], held))):
        return cache[2]
    canvas = _to_dense_device(m)
    m._dense_canvas = (held, versions, canvas)
    return canvas


def _carve_padded_reshape(cd: torch.Tensor, nbr: int, nbc: int, bm: int, bn: int):
    """The full row-major block pattern of a canvas whose blocking is
    (near-)uniform with leading sizes (bm, bn): pad to (nbr*bm, nbc*bn)
    and permute, (nbr*nbc, bm, bn), contiguous."""
    pm, pn = nbr * bm - cd.shape[0], nbc * bn - cd.shape[1]
    if pm or pn:
        cd = torch.nn.functional.pad(cd, (0, pn, 0, pm))
    return cd.reshape(nbr, bm, nbc, bn).permute(0, 2, 1, 3).reshape(nbr * nbc, bm, bn)


def _full_pattern(c: BlockSparseMatrix, data: torch.Tensor) -> None:
    """Install ``data`` (nblkrows*nblkcols, bm, bn), C's full row-major
    pattern of a uniform blocking, as C's one bin."""
    n = c.nblkrows * c.nblkcols
    bm, bn = int(data.shape[1]), int(data.shape[2])
    c.set_structure_from_device(
        np.arange(n, dtype=np.int64), [_Bin((bm, bn), data, n)],
        binning=(np.zeros(n, np.int32), np.arange(n, dtype=np.int32), [(bm, bn)]))


def carve_full_pattern(c: BlockSparseMatrix, cd: torch.Tensor) -> None:
    """Carve a dense canvas into ``c``'s FULL block pattern, bin by bin
    (`dbcsr_make_undense`, `dbcsr_mm.F:770-810`).  A near-uniform
    blocking (uniform but for a smaller last block row or column) carves
    by the padded reshape, then one block-granular take per bin with the
    edge blocks cropped; any other blocking by element-offset gathers."""
    nbr, nbc = c.nblkrows, c.nblkcols
    new_keys = np.arange(nbr * nbc, dtype=np.int64)
    rows, cols = new_keys // nbc, new_keys % nbc
    nb, nsl, shapes = _bin_entries(c.row_blk_sizes, c.col_blk_sizes, rows, cols)
    carved = None
    if _near_uniform(c.row_blk_sizes) and _near_uniform(c.col_blk_sizes):
        carved = _carve_padded_reshape(cd, nbr, nbc, int(c.row_blk_sizes[0]),
                                       int(c.col_blk_sizes[0]))
    roff, coff = c.row_blk_offsets[rows], c.col_blk_offsets[cols]
    dev = c.device
    bins = []
    for b_id, (bm, bn) in enumerate(shapes):
        sel = np.nonzero(nb == b_id)[0]
        if carved is not None and len(shapes) == 1:
            data = carved
        elif carved is not None:
            idx = np.empty(len(sel), np.int64)
            idx[nsl[sel]] = sel  # the flat key is the carved row
            data = carved[to_index(idx, dev)][:, :bm, :bn].contiguous()
        else:
            ro = np.empty(len(sel), np.int64)
            co = np.empty(len(sel), np.int64)
            ro[nsl[sel]] = roff[sel]
            co[nsl[sel]] = coff[sel]
            data = _gather_blocks(cd, ro, co, bm, bn)
        bins.append(_Bin((bm, bn), data, len(sel)))
    c.set_structure_from_device(new_keys, bins, binning=(nb, nsl, shapes))


def _dense_multiply(a, b, c, alpha, beta) -> int:
    """The dense format (ref `dbcsr_make_dense` + `use_dense_mult`,
    `dbcsr_mm.F:593-617,770-810`): scatter the operands onto canvases,
    one GEMM, carve C back as its full block pattern.  Uniform blockings
    carve by a reshape and merge beta*C block-granularly; others take
    `_dense_multiply_general`; canvases over `_DENSE_MAX_CANVAS` elements
    take `_dense_multiply_chunked`.  Returns the true flops."""
    if faults.active():
        faults.maybe_inject("dense")
    if not (_uniform(a) and _uniform(b) and _uniform(c)):
        return _dense_multiply_general(a, b, c, alpha, beta)
    bm, bn = int(c.row_blk_sizes[0]), int(c.col_blk_sizes[0])
    if max(a.nfullrows * a.nfullcols, a.nfullcols * b.nfullcols,
           a.nfullrows * b.nfullcols) > _DENSE_MAX_CANVAS:
        return _dense_multiply_chunked(a, b, c, alpha, beta)
    ad, bd = _dense_canvas_cached(a), _dense_canvas_cached(b)
    cd = torch.matmul(ad, bd)
    nbr, nbc = c.nblkrows, c.nblkcols
    out = _carve_padded_reshape(cd, nbr, nbc, bm, bn)
    del cd
    if alpha != 1:
        out.mul_(alpha)
    if beta != 0 and c.nblks:
        # one bin: its slots are the entries in key order
        out.index_add_(0, to_index(c.keys, c.device), c.bins[0].data, alpha=beta)
    out = _dense_guard(out)
    if abft.enabled():
        # the carved blocks are a permutation of the result canvas
        res = out.reshape(nbr, nbc, bm, bn).permute(0, 2, 1, 3).reshape(nbr * bm, nbc * bn)
        c_old = _to_dense_device(c) if beta != 0 and c.nblks else None
        abft.check_dense_canvas(res, ad, bd, c_old, alpha, beta, dtype=c.dtype)
        del res, c_old
    _full_pattern(c, out)
    return _true_product_flops(a, b)


def _dense_multiply_general(a, b, c, alpha, beta) -> int:
    """The dense format for any blocking (the north star's 434x23 + 18):
    densify on the device, one GEMM, add beta * C's canvas, carve C back
    into its own full blocking."""
    ad, bd = _dense_canvas_cached(a), _dense_canvas_cached(b)
    cd = torch.matmul(ad, bd)
    if alpha != 1:
        cd.mul_(alpha)
    c_old = _to_dense_device(c) if beta != 0 and c.nblks else None
    if c_old is not None:
        cd.add_(c_old, alpha=beta)
    cd = _dense_guard(cd)
    if abft.enabled():
        abft.check_dense_canvas(cd, ad, bd, c_old, alpha, beta, dtype=c.dtype)
    del c_old
    carve_full_pattern(c, cd)
    return _true_product_flops(a, b)


def _dense_multiply_chunked(a, b, c, alpha, beta) -> int:
    """The dense format beyond the canvas cap, for uniform blockings:
    tile over k-strips (and m- and n-strips when the C canvas is too big)
    so every live canvas stays under `_DENSE_MAX_CANVAS` elements, each
    C tile summing its k-strip products in order."""
    bm, bn, bk = int(c.row_blk_sizes[0]), int(c.col_blk_sizes[0]), int(a.col_blk_sizes[0])
    nbr, nbc, nbk = a.nblkrows, c.nblkcols, a.nblkcols
    chunking = _dense_chunking(nbr, nbc, nbk, bm, bn, bk)
    if chunking is None:
        # not even single-block strips fit the cap: one canvas after all
        return _dense_multiply_general(a, b, c, alpha, beta)
    mrb, kcb, ncb = chunking
    ar, ac = a.entry_coords()
    br, bc = b.entry_coords()
    cr, cc = c.entry_coords()
    dev, dt = c.device, c.dtype

    def strip(m, rows, cols, r0, r1, k0, k1, shape, rb, cb):
        """A canvas of ``shape`` holding m's blocks in the block window
        [r0, r1) x [k0, k1)."""
        canvas = torch.zeros(shape, dtype=dt, device=dev)
        sel = np.nonzero((rows >= r0) & (rows < r1) & (cols >= k0) & (cols < k1))[0]
        if len(sel):
            _scatter_blocks(canvas, m.bins[0].data[to_index(sel, dev)],
                            (rows[sel] - r0) * rb, (cols[sel] - k0) * cb)
        return canvas

    parts = []
    for r0 in range(0, nbr, mrb):
        r1 = min(nbr, r0 + mrb)
        tiles = []
        for c0 in range(0, nbc, ncb):
            c1 = min(nbc, c0 + ncb)
            cd = torch.zeros((mrb * bm, ncb * bn), dtype=dt, device=dev)
            for k0 in range(0, nbk, kcb):
                k1 = min(nbk, k0 + kcb)
                cd += torch.matmul(strip(a, ar, ac, r0, r1, k0, k1, (mrb * bm, kcb * bk), bm, bk),
                                   strip(b, br, bc, k0, k1, c0, c1, (kcb * bk, ncb * bn), bk, bn))
            out = _carve_padded_reshape(cd, mrb, ncb, bm, bn)
            if alpha != 1:
                out.mul_(alpha)
            sel = np.nonzero((cr >= r0) & (cr < r1) & (cc >= c0) & (cc < c1))[0]
            if beta != 0 and len(sel):
                out.index_add_(0, to_index((cr[sel] - r0) * ncb + (cc[sel] - c0), dev),
                               c.bins[0].data[to_index(sel, dev)], alpha=beta)
            tiles.append(out.reshape(mrb, ncb, bm, bn)[: r1 - r0, : c1 - c0])
        parts.append(torch.cat(tiles, dim=1).reshape((r1 - r0) * nbc, bm, bn))
    _full_pattern(c, _dense_guard(torch.cat(parts) if len(parts) > 1 else parts[0]))
    return _true_product_flops(a, b)


# -------------------------------------------------------- composite format
class _PanelPack:
    """Host plan of the composite format: a greedy contiguous partition
    of A's block rows into ``G`` row panels, each padded to ``mp`` block
    rows and carrying its own compacted k-support of at most ``kp``
    block columns, so one batched GEMM multiplies every panel against its
    own copy of the B rows it needs."""

    __slots__ = ("G", "mp", "kp", "row_panel", "row_local", "kmap")

    def __init__(self, G, mp, kp, row_panel, row_local, kmap):
        self.G = int(G)     # panel count (batch dim)
        self.mp = int(mp)   # block rows per panel (padded)
        self.kp = int(kp)   # k-support block columns per panel (padded)
        self.row_panel = row_panel  # (nbr,) block row -> panel id
        self.row_local = row_local  # (nbr,) block row -> row in panel
        self.kmap = kmap    # (G, nbk) global k -> panel-local k or -1


_panel_cache: OrderedDict = OrderedDict()


def composite_panels(a, b, c) -> Optional[_PanelPack]:
    """The composite plan of this product, or None when the pattern
    offers no compression over one dense canvas.  Memoized by the
    operands' pattern fingerprints and the packing limits."""
    cfg = get_config()
    if a.nblks == 0 or b.nblks == 0:
        return None
    if not (_uniform(a) and _uniform(b) and _uniform(c)):
        return None
    nbr, nbk = a.nblkrows, a.nblkcols
    if nbr < 2 or float(nbr) * nbk > 5e7:
        return None
    key = (a.pattern_fingerprint(), b.pattern_fingerprint(),
           int(cfg.composite_max_panels), float(cfg.composite_ksup))
    if key in _panel_cache:
        _panel_cache.move_to_end(key)
        return _panel_cache[key]
    pack = _build_panels(a, b, c, cfg)
    _panel_cache[key] = pack
    while len(_panel_cache) > 64:
        _panel_cache.popitem(last=False)
    return pack


def _greedy_panel_partition(support, limit, max_panels):
    """One greedy pass: walk the block rows in order, closing a panel when
    its k-support union would exceed ``limit``; then merge the adjacent
    pair with the smallest combined support until at most ``max_panels``
    remain.  Returns (bounds, sups)."""
    nbr = support.shape[0]
    bounds, sups = [], []
    cur, start = support[0].copy(), 0
    for r in range(1, nbr):
        new = cur | support[r]
        if int(new.sum()) > limit:
            bounds.append((start, r))
            sups.append(cur)
            start, cur = r, support[r].copy()
        else:
            cur = new
    bounds.append((start, nbr))
    sups.append(cur)
    while len(bounds) > max_panels:
        unions = [int((sups[i] | sups[i + 1]).sum()) for i in range(len(sups) - 1)]
        i = int(np.argmin(unions))
        bounds[i] = (bounds[i][0], bounds[i + 1][1])
        sups[i] = sups[i] | sups[i + 1]
        del bounds[i + 1], sups[i + 1]
    return bounds, sups


def _build_panels(a, b, c, cfg) -> Optional[_PanelPack]:
    """Greedy contiguous panels (see `_PanelPack`): try a few k-support
    close limits under ``composite_ksup * nbk`` and keep the partition
    with the smallest padded volume.  None when batching cannot beat one
    canvas (no k compression, padding or B-duplication blowup, or a
    canvas over the cap)."""
    nbr, nbk, nbc = a.nblkrows, a.nblkcols, b.nblkcols
    bm, bn, bk = int(c.row_blk_sizes[0]), int(c.col_blk_sizes[0]), int(a.col_blk_sizes[0])
    ar, ac = a.entry_coords()
    if np.bincount(ar, minlength=nbr).max() >= nbk:
        return None  # a full row of A: every panel's k-support is all of k
    support = np.zeros((nbr, nbk), bool)
    support[ar, ac] = True
    ksup_limit = max(1, int(cfg.composite_ksup * nbk))
    best = None
    cap = _DENSE_MAX_CANVAS
    n_el = nbc * bn
    for lim in sorted({ksup_limit, max(1, nbk // 2), max(1, nbk // 4), max(1, nbk // 8)}):
        if lim > ksup_limit:
            continue
        bounds, sups = _greedy_panel_partition(support, lim, cfg.composite_max_panels)
        G = len(bounds)
        if G < 2:
            continue
        mp = max(r1 - r0 for r0, r1 in bounds)
        kp = max(int(s.sum()) for s in sups)
        if kp >= nbk:
            continue  # no k compression: plain dense dominates
        if float(G) * mp * kp >= 0.9 * float(nbr) * nbk:
            continue  # padding eats the compression
        if sum(int(s.sum()) for s in sups) > 3 * nbk:
            continue  # too many B rows copied into several panels
        if (G * mp * bm * kp * bk > cap or G * kp * bk * n_el > cap
                or G * mp * bm * n_el > cap):
            continue
        if best is None or G * mp * kp < best[0]:
            best = (G * mp * kp, bounds, sups, G, mp, kp)
    if best is None:
        return None
    _, bounds, sups, G, mp, kp = best
    row_panel = np.empty(nbr, np.int64)
    row_local = np.empty(nbr, np.int64)
    kmap = np.full((G, nbk), -1, np.int64)
    for g, (r0, r1) in enumerate(bounds):
        row_panel[r0:r1] = g
        row_local[r0:r1] = np.arange(r1 - r0)
        supp_idx = np.nonzero(sups[g])[0]
        kmap[g, supp_idx] = np.arange(len(supp_idx))
    return _PanelPack(G, mp, kp, row_panel, row_local, kmap)


def _composite_multiply(a, b, c, alpha, beta, pack: _PanelPack) -> int:
    """The composite format: scatter the A panels and each panel's copy of
    its B rows onto canvases, one batched GEMM (`torch.bmm`) over the
    panels, then carve C's full pattern (panel-major reshape, one
    block-granular take into key order) and merge beta*C.  Returns the
    true flops."""
    if faults.active():
        faults.maybe_inject("dense")
    bm, bn, bk = int(c.row_blk_sizes[0]), int(c.col_blk_sizes[0]), int(a.col_blk_sizes[0])
    nbr, nbc = a.nblkrows, c.nblkcols
    G, mp, kp = pack.G, pack.mp, pack.kp
    dev, dt = c.device, c.dtype
    ar, ac = a.entry_coords()
    br, bc = b.entry_coords()
    g_e = pack.row_panel[ar]
    ad = torch.zeros((G * mp * bm, kp * bk), dtype=dt, device=dev)
    # a panel's k-support is the union of its rows' columns: kmap >= 0
    _scatter_blocks(ad, a.bins[0].data, (g_e * mp + pack.row_local[ar]) * bm,
                    pack.kmap[g_e, ac] * bk)
    dup, b_ro, b_co = [], [], []
    for g in range(G):
        kl = pack.kmap[g, br]
        sel = np.nonzero(kl >= 0)[0]
        dup.append(sel)
        b_ro.append((g * kp + kl[sel]) * bk)
        b_co.append(bc[sel] * bn)
    bd = torch.zeros((G * kp * bk, nbc * bn), dtype=dt, device=dev)
    _scatter_blocks(bd, b.bins[0].data[to_index(np.concatenate(dup), dev)],
                    np.concatenate(b_ro), np.concatenate(b_co))
    ad, bd = ad.view(G, mp * bm, kp * bk), bd.view(G, kp * bk, nbc * bn)
    pd = _dense_guard(torch.bmm(ad, bd))
    if abft.enabled():
        abft.check_dense_canvas_batched(pd, ad, bd, dtype=c.dtype)
    del ad, bd
    carved = pd.reshape(G, mp, bm, nbc, bn).permute(0, 1, 3, 2, 4).reshape(G * mp * nbc, bm, bn)
    del pd
    keys = np.arange(nbr * nbc, dtype=np.int64)
    rows = keys // nbc
    out = carved[to_index((pack.row_panel[rows] * mp + pack.row_local[rows]) * nbc
                          + keys % nbc, dev)]
    del carved
    if alpha != 1:
        out.mul_(alpha)
    if beta != 0 and c.nblks:
        out.index_add_(0, to_index(c.keys, dev), c.bins[0].data, alpha=beta)
    _full_pattern(c, out)
    return _true_product_flops(a, b)
