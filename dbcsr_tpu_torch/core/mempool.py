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

The JAX package's buffer recycling (`zeros`/`release`), index mirrors
(`upload_index`) and `snapshot`/`restore` are not ported: the allocator
recycles, plans keep their own device indices, and the snapshots serve
only the models' integrity guard, which is not ported either.
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
            tracked.free()

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
