"""Dynamic lock-order assertion.

Counterpart of `dbcsr_tpu/utils/lockcheck.py`.  Debug-gated by
``DBCSR_TPU_TORCH_LOCKCHECK=1``: the instrumented locks (the memory
pool's and the telemetry store's) record each thread's acquisition
order into a global edge set; taking B while holding A after some
thread took A while holding B raises `LockOrderError` at once, with
both witness chains, instead of a deadlock under the right
interleaving.

Off (the default) `wrap` hands the raw lock back: no wrapper, no cost.
"""

from __future__ import annotations

import os
import threading


class LockOrderError(RuntimeError):
    """Two locks were taken in both orders (see message witnesses)."""


_edges: dict = {}        # (first, second) -> witness string
_edges_lock = threading.Lock()
_held = threading.local()  # .stack: per-thread list of held names


def enabled() -> bool:
    return os.environ.get("DBCSR_TPU_TORCH_LOCKCHECK") == "1"


def wrap(name: str, lock):
    """Instrument ``lock`` under ``name`` when the checker is on;
    hand the raw lock back untouched otherwise."""
    return TrackedLock(name, lock) if enabled() else lock


def reset() -> None:
    """Forget every recorded ordering (tests)."""
    with _edges_lock:
        _edges.clear()


def held_names() -> tuple:
    """This thread's current lock chain, outermost first (tests)."""
    return tuple(getattr(_held, "stack", ()))


def _stack() -> list:
    st = getattr(_held, "stack", None)
    if st is None:
        st = _held.stack = []
    return st


def _note_acquired(name: str) -> None:
    st = _stack()
    me = threading.current_thread().name
    witness = f"{me}: {' -> '.join(st + [name])}"
    with _edges_lock:
        for h in st:
            if h == name:
                continue  # re-entrant RLock acquire
            inverse = _edges.get((name, h))
            if inverse is not None:
                raise LockOrderError(
                    f"lock order inversion: `{h}` -> `{name}` here "
                    f"({witness}) but `{name}` -> `{h}` was recorded "
                    f"({inverse}) — a deadlock under the right "
                    "interleaving")
            _edges.setdefault((h, name), witness)
    st.append(name)


def _note_released(name: str) -> None:
    st = _stack()
    # release may be out of LIFO order (rare but legal): drop the
    # newest matching hold
    for i in range(len(st) - 1, -1, -1):
        if st[i] == name:
            del st[i]
            return


class TrackedLock:
    """Lock proxy recording acquisition order.  Works as a Condition
    base too: `threading.Condition` only needs acquire/release and
    context-manager protocol, and its ``wait`` releases through them,
    keeping the per-thread chain truthful across waits."""

    def __init__(self, name: str, lock):
        self.name = name
        self._lock = lock

    def acquire(self, *args, **kwargs) -> bool:
        ok = self._lock.acquire(*args, **kwargs)
        if ok:
            try:
                _note_acquired(self.name)
            except LockOrderError:
                self._lock.release()
                raise
        return ok

    def release(self) -> None:
        self._lock.release()
        _note_released(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
