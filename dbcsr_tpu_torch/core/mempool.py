"""Device residency: the chain that owns an iteration's matrices.

Counterpart of the chain half of `dbcsr_tpu/core/mempool.py` (ref the
data-area pools of `dbcsr_mem_methods.F`).  On the H100 the pool is
torch's caching allocator: a matrix that a `chain` retires drops its
bins, so their blocks return to the allocator and the next iteration's
tensors of the same size reuse them without a `cudaMalloc`.
`pool_stats` reads the allocator's counters.

* ``enabled``/``set_enabled`` (env ``DBCSR_TPU_TORCH_POOL``, on unless
  "0"/"false"/"no"): the residency knob.  It gates the filtered leg of
  the multiply's plan cache (`mm/multiply.py`), as in the JAX package.
* `chain`: a context manager that adopts every matrix created inside it
  (`BlockSparseMatrix.__init__` asks `current_chain`).  ``retire`` frees
  an adopted matrix now, ``detach`` lets a result escape (to the
  enclosing chain when there is one), ``scope`` frees what one split of
  a loop adopted (the TAS split loop), and whatever is still adopted at
  exit is freed.

* `snapshot_matrix`/`restore_matrix` and ``chain.snapshot``/``restore``
  (ref `dbcsr_tpu/core/mempool.py:372-560`): the models' integrity guard
  checkpoints each accepted iterate and rolls back to it.  A snapshot
  clones the bins (the port's tensors are mutable); a restore installs
  fresh clones, so one snapshot can be restored twice, and the matrix's
  new bins make the plan cache, the canvas cache and the norm memo miss.
  Restoring a matrix its chain retired after the snapshot raises
  `SnapshotError`.

* `zeros`/`release`/`pool_stats`/`clear` (ref
  `dbcsr_tpu/core/mempool.py:147-307`): the JAX package's free lists
  over torch's caching allocator.  `release` banks a tensor the caller
  gives up and `zeros` hands back a banked one of the same shape and
  dtype, zeroed in place (a hit), or a fresh one (a miss); the counters
  are the JAX package's.  The allocator already recycles freed blocks,
  so the engine itself banks nothing.
* `record_h2d`/`record_d2h`/`transfer_totals`: bytes staged to and
  fetched from the device.
* `upload_index`: the content-keyed device mirror of host index arrays
  (an LRU bounded by entries and bytes; the key embeds the bytes' sha1,
  so it is never stale).
* `alias_bins`/`adopt_aliased_bins`: the zero-copy result snapshot the
  incremental multiply caches, and its installation into a matrix.
  Both mark the matrix's bins shared, so its next in-place write gives
  it fresh bins first (`BlockSparseMatrix.own_bins`).

The JAX package's `run_donated` (a donating jitted call with its
warning silenced) has no counterpart: torch has no buffer donation, and
the port writes in place where the JAX package donates.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.obs import metrics as _metrics
from dbcsr_tpu_torch.utils import lockcheck as _lockcheck

_enabled = os.environ.get("DBCSR_TPU_TORCH_POOL", "1") not in ("0", "false", "no")
_lock = _lockcheck.wrap("core.mempool", threading.Lock())

# matrices freed by chains and the device bytes their bins held; the
# free lists' checkouts, returns and evictions and the bytes they hold;
# host<->device transfer bytes
_stats = {"freed": 0, "freed_bytes": 0, "hits": 0, "misses": 0, "returns": 0,
          "evictions": 0, "bytes_held": 0, "high_water": 0, "h2d_bytes": 0, "d2h_bytes": 0}
_generation = 0  # `reset_stats` calls
# the free lists' budget (the JAX package's default, 2 GiB)
_POOL_BUDGET_BYTES = 2 << 30


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Programmatic residency toggle (the control leg of an A/B)."""
    global _enabled
    _enabled = bool(on)


def note_freed(nbytes: int) -> None:
    """Count one matrix freed and the bytes its bins held."""
    _stats["freed"] += 1
    _stats["freed_bytes"] += int(nbytes)


def _bump(kind: str, n: int = 1) -> None:
    _stats[kind] += n
    _metrics.counter(f"dbcsr_tpu_pool_{kind}_total",
                     "device memory pool events by kind (checkout hits/misses, "
                     "buffer returns, budget evictions)").inc(n)


def record_h2d(nbytes: int) -> None:
    """Count one host->device staging transfer."""
    if nbytes:
        _stats["h2d_bytes"] += int(nbytes)
        _metrics.counter("dbcsr_tpu_h2d_bytes_total",
                         "host->device bytes staged (block data + index uploads)"
                         ).inc(int(nbytes))


def record_d2h(nbytes: int) -> None:
    """Count one device->host fetch."""
    if nbytes:
        _stats["d2h_bytes"] += int(nbytes)
        _metrics.counter("dbcsr_tpu_d2h_bytes_total",
                         "device->host bytes fetched (block reads + host-driver "
                         "round-trips)").inc(int(nbytes))


def transfer_totals() -> dict:
    """{"h2d": bytes, "d2h": bytes} since the last `reset_stats`."""
    return {"h2d": _stats["h2d_bytes"], "d2h": _stats["d2h_bytes"]}


def stats_generation() -> int:
    """How many times `reset_stats` ran: a reader that took a baseline of
    `transfer_totals` under another generation counts from zero."""
    return _generation


def reset_stats() -> None:
    """Zero the counters; held buffers and mirrors stay (`clear` drops
    them)."""
    global _generation
    _generation += 1
    with _lock:
        for k in _stats:
            _stats[k] = 0
        _stats["bytes_held"] = sum(_nbytes(t) for lst in _free.values() for t in lst)
        _stats["high_water"] = _stats["bytes_held"]


# ------------------------------------------------------------ free lists
# (shape, dtype, device) -> [released tensors]
_free: dict = {}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def zeros(shape, dtype, device=None) -> torch.Tensor:
    """A zeroed tensor of ``shape``/``dtype`` on ``device``: a released
    one zeroed in place (a checkout hit) or a fresh one (a miss)."""
    shape = tuple(int(x) for x in shape)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if not _enabled:
        return torch.zeros(shape, dtype=dtype, device=dev)
    key = (shape, dtype, str(dev))
    with _lock:
        lst = _free.get(key)
        buf = lst.pop() if lst else None
        if lst is not None and not lst:
            _free.pop(key, None)
        if buf is not None:
            _stats["bytes_held"] -= _nbytes(buf)
        _bump("hits" if buf is not None else "misses")
    return buf.zero_() if buf is not None else torch.zeros(shape, dtype=dtype, device=dev)


def release(t: torch.Tensor) -> bool:
    """Bank a tensor for a later `zeros`.  The caller gives it up: no
    other reference may read or write it again.  Returns whether it was
    banked (over the budget the oldest banked tensors are evicted; one
    larger than the budget is dropped)."""
    if not _enabled or not isinstance(t, torch.Tensor):
        return False
    nbytes = _nbytes(t)
    with _lock:
        if nbytes > _POOL_BUDGET_BYTES:
            _bump("evictions")
            return False
        while _stats["bytes_held"] + nbytes > _POOL_BUDGET_BYTES and _free:
            k0 = next(iter(_free))
            old = _free[k0].pop(0)
            if not _free[k0]:
                del _free[k0]
            _stats["bytes_held"] -= _nbytes(old)
            _bump("evictions")
        _free.setdefault((tuple(t.shape), t.dtype, str(t.device)), []).append(t)
        _stats["bytes_held"] += nbytes
        _stats["high_water"] = max(_stats["high_water"], _stats["bytes_held"])
        _bump("returns")
    return True


def clear() -> None:
    """Drop every banked tensor and every index mirror."""
    global _mirror_bytes
    with _lock:
        _free.clear()
        _mirror.clear()
        _mirror_bytes = 0
        _stats["bytes_held"] = 0


# ---------------------------------------------------------- index mirror
# (tag, shape, dtype, sha1 of the bytes, device) -> device tensor
_mirror: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_mirror_bytes = 0
_MIRROR_MAX_ENTRIES = 512
_MIRROR_MAX_BYTES = 128 * 1024 * 1024


def upload_index(tag: str, arr, device=None) -> torch.Tensor:
    """The device copy of a host index array, cached by content: a
    pattern-stable loop uploads each index once.  Callers never write
    into the result."""
    global _mirror_bytes
    arr = np.ascontiguousarray(arr)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if not _enabled:
        record_h2d(arr.nbytes)
        return torch.from_numpy(arr.copy()).to(dev)
    key = (tag, arr.shape, str(arr.dtype), hashlib.sha1(arr.tobytes()).digest(), str(dev))
    with _lock:
        hit = _mirror.get(key)
        if hit is not None:
            _mirror.move_to_end(key)
            return hit
    out = torch.from_numpy(arr.copy()).to(dev)
    record_h2d(arr.nbytes)
    with _lock:
        if key not in _mirror:
            _mirror[key] = out
            _mirror_bytes += _nbytes(out)
            while _mirror and (len(_mirror) > _MIRROR_MAX_ENTRIES
                               or _mirror_bytes > _MIRROR_MAX_BYTES):
                _, old = _mirror.popitem(last=False)
                _mirror_bytes -= _nbytes(old)
    return out


def alias_bins(m) -> tuple:
    """A zero-copy snapshot of ``m``'s bins, ``([(shape, data, count)],
    bytes)``: the caller must mark the matrix's bins shared, so a later
    in-place write gives the matrix fresh bins and never reaches the
    snapshot."""
    bins = [(b.shape, b.data, b.count) for b in m.bins]
    return bins, sum(_nbytes(d) for _, d, _ in bins)


def adopt_aliased_bins(m, keys, bins_snapshot, binning=None) -> None:
    """Install an `alias_bins` snapshot into ``m`` as its structure and
    bins, marked shared (the snapshot's holder keeps them); ``binning``
    is the snapshot's (entry bins, slots, bin shapes), when kept."""
    from dbcsr_tpu_torch.core.matrix import _Bin

    m.set_structure_from_device(np.ascontiguousarray(keys, np.int64).copy(),
                                [_Bin(shape, data, count) for shape, data, count in bins_snapshot],
                                binning=binning)
    m._bins_shared = True


def pool_stats(device=None) -> dict:
    """The chains' frees, the free lists' counters, the transfer bytes
    and, on a CUDA device, the caching allocator's current and peak
    allocated and reserved bytes (`torch.cuda.memory_stats`)."""
    out = dict(_stats, enabled=_enabled, budget_bytes=_POOL_BUDGET_BYTES, buckets=len(_free),
               mirror_entries=len(_mirror), mirror_bytes=_mirror_bytes)
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        ms = torch.cuda.memory_stats(dev)
        for key in ("allocated_bytes.all.current", "allocated_bytes.all.peak",
                    "reserved_bytes.all.current", "reserved_bytes.all.peak",
                    "num_alloc_retries"):
            out[key] = int(ms.get(key, 0))
    return out


class SnapshotError(RuntimeError):
    """A checkpoint/rollback contract violation (restoring a snapshot
    whose matrix was retired after it)."""


class MatrixSnapshot:
    """A point-in-time checkpoint of one matrix: copies of its index
    arrays and clones of its bins on their device, owned by the snapshot
    alone, so it stays valid whatever later happens to the matrix."""

    __slots__ = ("matrix", "keys", "row_ptr", "ent_bin", "ent_slot", "bins", "valid",
                 "chain_owner")

    def __init__(self, m, chain_owner: Optional["chain"] = None):
        self.matrix = m
        self.keys = m.keys.copy()
        self.row_ptr = m.row_ptr.copy()
        self.ent_bin = m.ent_bin.copy()
        self.ent_slot = m.ent_slot.copy()
        self.bins = [(b.shape, b.data.clone(), b.count) for b in m.bins]
        self.valid = m.valid
        self.chain_owner = chain_owner

    def nbytes(self) -> int:
        return sum(d.numel() * d.element_size() for _, d, _ in self.bins)


def snapshot_matrix(m, chain_owner: Optional["chain"] = None) -> MatrixSnapshot:
    """Checkpoint ``m``'s structure and device data."""
    return MatrixSnapshot(m, chain_owner=chain_owner)


def restore_matrix(snap: MatrixSnapshot):
    """Roll ``snap.matrix`` back to the snapshot: its index arrays
    replaced by copies and its bins by fresh clones of the snapshot's
    (which stays reusable).  Returns the matrix."""
    from dbcsr_tpu_torch.core.matrix import _Bin

    m = snap.matrix
    m.keys = snap.keys.copy()
    m.row_ptr = snap.row_ptr.copy()
    m.ent_bin = snap.ent_bin.copy()
    m.ent_slot = snap.ent_slot.copy()
    m.bins = [_Bin(shape, data.clone(), count) for shape, data, count in snap.bins]
    m._work.clear()
    m._work_batches.clear()
    m._dense_canvas = None
    m._norms_memo = None
    m._bins_shared = False
    # the epoch stays monotone through a rollback, and everything reads
    # as changed (a restored C is never served as current)
    m._note_mutation(None)
    m.valid = snap.valid
    return m


# per-thread chain stack: a chain entered on one thread never adopts
# (and later frees) matrices another thread is building
_chain_tls = threading.local()


def _stack() -> list:
    st = getattr(_chain_tls, "stack", None)
    if st is None:
        st = _chain_tls.stack = []
    return st


def current_chain() -> Optional["chain"]:
    """The innermost chain active on this thread, or None."""
    st = _stack()
    return st[-1] if st else None


class chain:
    """Scope of an iteration's matrices (ref `dbcsr_tpu/core/mempool.py:474-618`)::

        with chain() as ch:
            cur = p0
            for _ in range(steps):
                new = step(cur)          # temporaries auto-adopted
                if cur is not p0:
                    ch.retire(cur)       # bins back to the allocator
                cur = new
            ch.detach(cur)
        return cur
    """

    def __init__(self):
        self._adopted: dict = {}  # id(matrix) -> matrix

    def __enter__(self) -> "chain":
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            _stack().remove(self)
        except ValueError:
            pass
        for m in list(self._adopted.values()):
            m.free()
        self._adopted.clear()
        return False

    def adopt(self, m) -> object:
        """Track ``m`` for this chain's end-of-scope free."""
        self._adopted[id(m)] = m
        return m

    def retire(self, m) -> None:
        """Free an adopted matrix now; a no-op for a matrix this chain
        does not own (a caller's input is never freed)."""
        tracked = self._adopted.pop(id(m), None)
        if tracked is not None:
            # stamped on the matrix, not kept as an id: a retired
            # matrix's id may be reused by a later one
            tracked._chain_retired = True
            tracked.free()

    def snapshot(self, m) -> MatrixSnapshot:
        """Checkpoint ``m`` (chain-owned or a caller's input), restorable
        through `restore`: the models checkpoint the accepted iterate
        before a step and roll back to it instead of iterating on a
        corrupted one."""
        return snapshot_matrix(m, chain_owner=self)

    def restore(self, snap: MatrixSnapshot):
        """Roll the snapshotted matrix back to its checkpoint; ownership
        does not change.  A matrix retired after the snapshot raises
        `SnapshotError` (its storage was given up)."""
        if getattr(snap.matrix, "_chain_retired", False):
            raise SnapshotError(
                f"cannot restore {snap.matrix.name!r}: the matrix was retired after the "
                f"snapshot (take the snapshot before retiring, or retire once the "
                f"iterate is validated)")
        return restore_matrix(snap)

    @contextlib.contextmanager
    def scope(self):
        """One split or iteration of a loop inside this chain (ref
        `dbcsr_tpu/core/mempool.py:568`): the matrices adopted while the
        scope is open (engine temporaries: desymmetrized operands,
        transposes, remapped tensors) are freed at its exit unless they
        were retired or detached meanwhile.  Matrices adopted before it
        (and the caller's, never adopted) are untouched."""
        before = set(self._adopted)
        try:
            yield self
        finally:
            for key in [k for k in self._adopted if k not in before]:
                self._adopted.pop(key).free()

    def detach(self, m) -> object:
        """Release ``m`` from this chain's free: to the enclosing chain
        when one is active, else it escapes.  A matrix this chain never
        owned stays unowned (an enclosing chain must not free a
        caller's input)."""
        if self._adopted.pop(id(m), None) is None:
            return m
        st = _stack()
        parent = None
        if self in st:
            i = st.index(self)
            parent = st[i - 1] if i > 0 else None
        elif st:
            parent = st[-1]
        if parent is not None:
            parent.adopt(m)
        return m
