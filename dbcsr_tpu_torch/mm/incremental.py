"""The delta-aware incremental multiply: recompute only what changed.

The port's copy of `dbcsr_tpu/mm/incremental.py`.  When a product's
plan key repeats (same patterns, scalars and options) and its operands
are the same objects, changed since the cached run in a known set of
blocks (the mutation journal of `core.matrix.BlockSparseMatrix`), only
the C blocks whose accumulation reads a changed A or B block are
recomputed; the rest are spliced from the cached result.  C is not
rebuilt: it takes the cached structure and a copy of the cached bins,
the affected blocks zeroed, and only their products run into them.

**Bit for bit the full product.**  A C block's sum is its run of
products in (C block, A entry) order, computed by one warp or one
thread block with no atomics (`acc/stack_kernel.py`,
`acc/crosspack_kernel.py`) and added to a zero block: its bits do not
depend on which other runs share the launch, pack or warp group, so the
subset run reproduces the recomputed blocks exactly, and the spliced
blocks are the cached bits that unchanged inputs would give.

**When a partial delta is spliced.**  A splice saves C's rebuild and
most of the stacks but plans the recomputed subset anew (a plan-cache
miss for each new delta), so on a small product or a large delta it
costs more than it saves.  The plane observes both sides on the host:
the full run's seconds after its index phase (assemble, plan, launch)
and each partial splice's own; a splice that lost marks its product's
key at its number of recomputed products, and deltas at least that
large recompute in full (``fallback_costly``).  A zero delta is always
reused.

**The safety ladder** (every rung ends in a full recompute, never in a
wrong answer): an unknown delta (a change of structure, a truncated or
foreign epoch, other operand objects, another C pattern) or a cached
bin written since its install (`tensor._version`) recomputes in full;
with ABFT on the assembled C is probed as a whole (`abft.verify_product`,
within the demotion ceilings of the specs its blocks were computed at
under ``precision="adaptive"``) and a mismatch recomputes in full; the
``incremental`` fault site makes the splice injectable; three failures
in a row open a breaker that turns the plane off for the process (an
``incremental_degrade`` event).

**The cache aliases C's bins**, as the JAX package's zero-copy snapshot
does (`core.mempool.alias_bins`).  The JAX package's arrays are
immutable; the port's are written in place, so the alias is guarded
twice: the matrix's bins are marked shared, which makes them
copy-on-write (`BlockSparseMatrix.own_bins`: `scale`, `set_value`, the
diagonal writes, `map_bin_data` and a partial splice clone first, and a
multiply or a finalize builds fresh bins anyway), and the entry records
each bin's version counter at install and is dropped when one moved.  An entry
larger than the 512 MB budget is never cached (the f64 north star's C,
792 MB).

The knob is ``incremental`` in `core.config`: "auto", "off" (no hooks
do anything) or "full" (the cache is kept, every product recomputes:
the comparison leg).  The JAX package's ``DBCSR_TPU_INCREMENTAL``
variable has no counterpart.
"""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np

from dbcsr_tpu_torch.core import digests, mempool
from dbcsr_tpu_torch.core.config import get_config
from dbcsr_tpu_torch.obs import events as _events
from dbcsr_tpu_torch.obs import flight as _flight
from dbcsr_tpu_torch.obs import metrics as _metrics

_CACHE_MAX_ENTRIES = 8
_CACHE_MAX_BYTES = 512 * 1024 * 1024
# recomputing almost everything pays the splice for nothing
_MAX_RECOMPUTE_FRACTION = 0.95
_BREAKER_THRESHOLD = 3  # failures in a row before the plane degrades


class _Entry:
    """One cached result: the operands (weakly: only their identity is
    checked) and their epochs, C's keys and binning, its aliased bins,
    each bin's version counter at install, and the demoted specs any of
    its blocks were computed at (the full-product probe's ceilings)."""

    __slots__ = ("a", "b", "a_epoch", "b_epoch", "keys", "binning", "bins", "versions",
                 "nbytes", "precisions", "full_s")

    def __init__(self, a, b, c, precisions, full_s):
        self.a = weakref.ref(a)
        self.b = weakref.ref(b)
        self.a_epoch = a.mutation_epoch
        self.b_epoch = b.mutation_epoch
        self.keys = c.keys
        self.binning = (c.ent_bin, c.ent_slot, [bin_.shape for bin_ in c.bins])
        self.bins, self.nbytes = mempool.alias_bins(c)
        self.versions = tuple(d._version for _, d, _ in self.bins)
        self.precisions = frozenset(precisions)
        # host seconds of the product's last full run after its index
        # phase (assemble, plan, launch): what a partial splice must beat
        self.full_s = full_s

    def written(self) -> bool:
        """Whether any cached bin was written in place since the install."""
        return any(d._version != v for (_, d, _), v in zip(self.bins, self.versions))


_cache: "OrderedDict[tuple, _Entry]" = OrderedDict()
_cache_bytes = 0
# plan keys run once, with their operands' ids: the second sighting with
# the same operands installs, so a one-off product pays no snapshot
_seen: "OrderedDict[tuple, tuple]" = OrderedDict()
_SEEN_MAX = 64

# per product key, the fewest recomputed products a partial splice of it
# has lost with (it cost the host more than the full run's `full_s`):
# deltas at least as large recompute in full
_lost_at: "OrderedDict[tuple, int]" = OrderedDict()

_breaker = {"failures": 0, "open": False}

# cumulative reuse totals (the models' per-iteration events diff them)
_totals = {"products": 0, "reused_blocks": 0, "recomputed_blocks": 0, "saved_flops": 0,
           "fallbacks": 0}


def _counter(result: str) -> None:
    _metrics.counter(
        "dbcsr_tpu_incremental_total",
        "delta-aware incremental multiply outcomes (hit_splice = partial recompute + "
        "splice, hit_unchanged = zero-delta full reuse, fallback_* = full recompute with "
        "the named reason; fallback_costly: a partial splice of this product at least as "
        "large lost to its full run on the host)",
    ).inc(result=result)


def mode() -> str:
    return get_config().incremental


def _key(plan_key, alpha) -> tuple:
    return (plan_key, digests.scalar_key(alpha))


def _drop(key) -> None:
    global _cache_bytes
    ent = _cache.pop(key, None)
    if ent is not None:
        _cache_bytes -= ent.nbytes


def note_format_executed(a, b) -> None:
    """A canvas format just restructured a C from these operands: drop the
    entries keyed to them now rather than let the epoch checks churn."""
    for k in [k for k, ent in _cache.items() if ent.a() is a or ent.b() is b]:
        _drop(k)


def reset() -> None:
    """Drop every cached result, close the breaker, zero the totals."""
    global _cache_bytes
    _cache.clear()
    _seen.clear()
    _lost_at.clear()
    _cache_bytes = 0
    _breaker.update(failures=0, open=False)
    for k in _totals:
        _totals[k] = 0


def cache_snapshot() -> dict:
    """{"entries", "bytes", "max_bytes"} of the result cache."""
    return {"entries": len(_cache), "bytes": _cache_bytes, "max_bytes": _CACHE_MAX_BYTES}


def stats_snapshot() -> dict:
    """The cumulative reuse totals (a copy); `reuse_delta` diffs them."""
    return dict(_totals)


def reuse_delta(prev: dict) -> dict:
    """The reuse between a `stats_snapshot` and now: products, blocks
    reused and recomputed, flops saved and the reuse fraction (0.0 when
    no eligible product ran)."""
    reused = _totals["reused_blocks"] - prev.get("reused_blocks", 0)
    recomputed = _totals["recomputed_blocks"] - prev.get("recomputed_blocks", 0)
    total = reused + recomputed
    return {"products": _totals["products"] - prev.get("products", 0),
            "reused_blocks": int(reused), "recomputed_blocks": int(recomputed),
            "saved_flops": int(_totals["saved_flops"] - prev.get("saved_flops", 0)),
            "reuse_fraction": round(reused / total, 6) if total else 0.0}


def _breaker_trip(reason: str) -> None:
    _totals["fallbacks"] += 1
    _breaker["failures"] += 1
    if _breaker["failures"] >= _BREAKER_THRESHOLD and not _breaker["open"]:
        _breaker["open"] = True
        _metrics.counter("dbcsr_tpu_incremental_degrade_total",
                         "incremental plane breaker opens (consecutive probe/fault failures; "
                         "the plane degrades to full recompute)").inc()
        _events.publish("incremental_degrade", {"reason": reason,
                                                "failures": _breaker["failures"]})


def _dirty_entry_mask(m, dirty_keys) -> Optional[np.ndarray]:
    """The entries of ``m`` whose key is dirty; None when a dirty key is
    not an entry (the journal speaks of another structure: unknown)."""
    mask = np.zeros(len(m.keys), bool)
    if not len(dirty_keys):
        return mask
    if not len(m.keys):
        return None
    pos = np.minimum(np.searchsorted(m.keys, dirty_keys), len(m.keys) - 1)
    if not bool(np.all(m.keys[pos] == dirty_keys)):
        return None
    mask[pos] = True
    return mask


class _SpliceRejected(Exception):
    """The splice was abandoned (a fault, a probe mismatch): recompute."""

    def __init__(self, result: str):
        super().__init__(result)
        self.result = result


def maybe_reuse(plan_key, a, b, c, alpha, new_keys, cand_keys, a_ent, b_ent) -> Optional[int]:
    """Try the delta-aware path for an eligible product (the caller checked
    the stack format, beta = 0, no limits, no filter, a non-symmetric C
    and a cacheable plan).  Returns the true flops it ran, or None for a
    full recompute.  A partial delta is spliced unless one at least as
    large already lost to this product's full run (`_lost_at`)."""
    t0 = time.perf_counter()
    md = mode()
    if md == "off":
        return None
    key = _key(plan_key, alpha)
    ent = _cache.get(key)
    if md == "full":
        if ent is not None:
            _counter("forced_full")
        return None
    if _breaker["open"]:
        if ent is not None:
            _counter("fallback_degraded")
        return None
    if ent is None:
        _counter("miss")
        return None
    if ent.a() is not a or ent.b() is not b:
        _counter("fallback_identity")
        _drop(key)
        return None
    dirty_a = a.dirty_keys_since(ent.a_epoch)
    dirty_b = b.dirty_keys_since(ent.b_epoch)
    if dirty_a is None or dirty_b is None or ent.written():
        _counter("fallback_epoch")
        _drop(key)
        return None
    if len(new_keys) != len(ent.keys) or not np.array_equal(new_keys, ent.keys):
        _counter("fallback_structure")  # C's union pattern moved
        _drop(key)
        return None
    amask = _dirty_entry_mask(a, dirty_a)
    bmask = _dirty_entry_mask(b, dirty_b)
    if amask is None or bmask is None:
        _counter("fallback_epoch")
        _drop(key)
        return None
    from dbcsr_tpu_torch.mm import multiply as _mm

    ntrip = len(cand_keys)
    lost_at = _lost_at.get(key, ntrip + 1)
    touched = np.zeros(ntrip, bool)
    if amask.any():
        touched |= amask[a_ent]
    if bmask.any():
        touched |= bmask[b_ent]
    if touched.any():
        # the products reading a changed block bound the recomputed ones
        # from below: a delta already too large skips the membership pass
        if int(touched.sum()) >= lost_at:
            _counter("fallback_costly")
            return None
        affected = np.unique(cand_keys[touched])
        recompute = np.isin(cand_keys, affected)
    else:
        affected = np.empty(0, np.int64)
        recompute = touched
    n_rec = int(recompute.sum())
    if ntrip and n_rec / ntrip > _MAX_RECOMPUTE_FRACTION:
        _counter("fallback_all_dirty")
        return None  # the full run's note_executed refreshes the entry
    if n_rec >= lost_at:
        _counter("fallback_costly")
        return None
    try:
        flops, precisions = _execute_splice(ent, a, b, c, alpha, cand_keys, a_ent, b_ent,
                                            recompute, affected, plan_key)
    except _SpliceRejected as exc:
        _counter(exc.result)
        _breaker_trip(exc.result)
        return None
    _breaker["failures"] = 0
    if n_rec and _slower_than_full(ent, time.perf_counter() - t0):
        _lost_at[key] = min(n_rec, _lost_at.get(key, n_rec))
        _lost_at.move_to_end(key)
        while len(_lost_at) > _SEEN_MAX:
            _lost_at.popitem(last=False)
    _install(key, a, b, c, precisions, ent.full_s)  # the new baseline: the assembled result
    n_reused = len(new_keys) - len(affected)
    saved = max(0, _mm._true_product_flops(a, b) - flops)
    _totals["products"] += 1
    _totals["reused_blocks"] += n_reused
    _totals["recomputed_blocks"] += len(affected)
    _totals["saved_flops"] += saved
    _counter("hit_unchanged" if n_rec == 0 else "hit_splice")
    _metrics.counter("dbcsr_tpu_incremental_saved_flops_total",
                     "true flops avoided by delta-aware reuse (full product flops minus the "
                     "recomputed subset's)").inc(saved)
    _metrics.counter("dbcsr_tpu_incremental_saved_bytes_total",
                     "device bytes of C blocks spliced from the cached result instead of "
                     "recomputed").inc(_spliced_bytes(c, affected))
    _flight.note("incremental", "unchanged" if n_rec == 0 else "splice")
    _flight.note("reuse_fraction", round(n_reused / max(len(new_keys), 1), 4))
    return int(flops)


def _slower_than_full(ent: _Entry, splice_s: float) -> bool:
    """Whether a partial splice cost the host more seconds than the
    product's last full run spent after its index phase."""
    return splice_s > ent.full_s


def _spliced_bytes(c, affected) -> int:
    """Device bytes of the C blocks served from the cache."""
    per_bin = np.bincount(c.ent_bin[np.searchsorted(c.keys, affected)], minlength=len(c.bins))
    return sum((bin_.count - int(n)) * bin_.shape[0] * bin_.shape[1] * bin_.data.element_size()
               for bin_, n in zip(c.bins, per_bin))


def _execute_splice(ent: _Entry, a, b, c, alpha, cand_keys, a_ent, b_ent, recompute, affected,
                    plan_key) -> tuple:
    """C takes the cached result's structure and bins (no rebuild); for a
    partial delta it owns copies of them, zeroes the affected blocks and
    runs only their products (launches guarded like any stack), which
    land on zero blocks exactly as the full product's do.  With ABFT on
    the assembled product is probed.  Returns the true flops run and
    the demoted specs C's blocks were computed at."""
    from dbcsr_tpu_torch.acc import abft
    from dbcsr_tpu_torch.core.matrix import to_index
    from dbcsr_tpu_torch.mm import multiply as _mm
    from dbcsr_tpu_torch.resilience import faults

    try:
        if faults.active():
            faults.maybe_inject("incremental", n=str(len(affected)))
        mempool.adopt_aliased_bins(c, ent.keys, ent.bins, binning=ent.binning)
        precisions = set(ent.precisions)
        flops = 0
        if len(affected):
            c.own_bins()  # copy-on-write: the cached bins stay as they are
            pos = np.searchsorted(c.keys, affected)
            for b_id, bin_ in enumerate(c.bins):
                sel = pos[c.ent_bin[pos] == b_id]
                if len(sel):
                    bin_.data.index_fill_(0, to_index(c.ent_slot[sel], c.device), 0)
            sub_key = plan_key + ("incremental", digests.index_digest(affected))
            entry, _ = _mm._spans_for(sub_key, c, a, b, cand_keys[recompute],
                                      a_ent[recompute], b_ent[recompute])
            spans = entry.spans
            flops = _mm._run_stacks(c, a, b, spans, alpha, cached=entry)
            _mm._refresh_cached_bytes(sub_key, entry)
            precisions.update(sp.plan.precision for sp in spans if sp.plan.precision is not None)
        if faults.active():
            c.map_bin_data(lambda d: faults.corrupt("incremental", d))
        if abft.enabled():
            abft.verify_product(a, b, c, alpha, 0.0, None, driver="incremental",
                                site="incremental", precisions=sorted(precisions))
        return flops, precisions
    except _SpliceRejected:
        raise
    except abft.AbftMismatchError as exc:
        abft.record_recovery("incremental")
        raise _SpliceRejected("fallback_abft") from exc
    except Exception as exc:  # noqa: BLE001 -- any failure recomputes in full
        raise _SpliceRejected("fallback_fault") from exc


def note_executed(plan_key, a, b, c, alpha, precisions=(), full_s: float = 0.0) -> None:
    """Record a fully run eligible product, ``precisions`` the demoted
    specs its stacks ran at and ``full_s`` its host seconds after the
    index phase: its first sighting with these operands only marks it
    seen; a repeat installs the result."""
    if mode() == "off":
        return
    key = _key(plan_key, alpha)
    ids = (id(a), id(b))
    if key not in _cache and _seen.get(key) != ids:
        _seen[key] = ids
        _seen.move_to_end(key)
        while len(_seen) > _SEEN_MAX:
            _seen.popitem(last=False)
        return
    _install(key, a, b, c, precisions, full_s)


def _install(key, a, b, c, precisions, full_s) -> None:
    """Cache ``c``'s result under ``key`` (aliasing its bins, which become
    copy-on-write), evicting the oldest entries past the budget; an
    entry over the byte budget alone is never cached."""
    global _cache_bytes
    _drop(key)
    ent = _Entry(a, b, c, precisions, full_s)
    if ent.nbytes > _CACHE_MAX_BYTES:
        return
    c._bins_shared = True
    _cache[key] = ent
    _cache_bytes += ent.nbytes
    while len(_cache) > _CACHE_MAX_ENTRIES or _cache_bytes > _CACHE_MAX_BYTES:
        _, evicted = _cache.popitem(last=False)
        _cache_bytes -= evicted.nbytes
