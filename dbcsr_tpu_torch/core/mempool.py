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

The JAX package's buffer recycling (`zeros`/`release`) and index mirrors
(`upload_index`) are not ported: the allocator recycles, and plans keep
their own device indices.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import torch

_enabled = os.environ.get("DBCSR_TPU_TORCH_POOL", "1") not in ("0", "false", "no")

# matrices freed by chains and the device bytes their bins held
_stats = {"freed": 0, "freed_bytes": 0}


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


def pool_stats(device=None) -> dict:
    """The chains' frees and, on a CUDA device, the caching allocator's
    current and peak allocated and reserved bytes
    (`torch.cuda.memory_stats`)."""
    out = dict(_stats)
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
