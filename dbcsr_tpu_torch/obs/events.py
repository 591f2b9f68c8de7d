"""Structured-event bus with per-multiply correlation ids.

The subset of `dbcsr_tpu/obs/events.py:99-312` the integrity plane
calls.  `mm.multiply` opens a ``product_id`` per multiply
(`product_scope`: `begin_product`, a flight record, then `end_product`;
nested multiplies form a per-thread stack), and every event published
while it is open carries it.  `publish` appends the event to a bounded
ring (`records`), forwards it to the flight recorder when asked
(``flight=``) and calls the subscribers.

Not ported yet (`ROADMAP.md`, obs): the JSONL sink, the process shard
naming, `rebind`, the tracer instants and the health and telemetry
feeds of `end_product`.  The ring holds ``RING_SIZE`` events; there is
no environment switch (`set_enabled` turns the ring off).

Stdlib-only.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
import uuid

from dbcsr_tpu_torch.obs import flight as _flight

RING_SIZE = 4096

_lock = threading.Lock()
_enabled = True
_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_seq = 0
_subscribers: list = []

# product-id stack, per thread: an event published on another thread
# never takes this thread's open product
_product_tls = threading.local()
_product_seq = 0
_TOKEN = f"{os.getpid():x}-{uuid.uuid4().hex[:6]}"


def _pstack() -> list:
    st = getattr(_product_tls, "stack", None)
    if st is None:
        st = _product_tls.stack = []
    return st


def subscribe(fn) -> None:
    """Call ``fn(record)`` for every ring record (after the append,
    outside the bus lock).  Idempotent per function."""
    if fn not in _subscribers:
        _subscribers.append(fn)


def unsubscribe(fn) -> None:
    try:
        _subscribers.remove(fn)
    except ValueError:
        pass


def enabled() -> bool:
    """Whether the bus records; when off `publish` only forwards to the
    flight recorder."""
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def begin_product(**fields) -> str:
    """Open a correlation id for the multiply that is starting."""
    global _product_seq
    with _lock:
        _product_seq += 1
        seq = _product_seq
    pid = f"{_TOKEN}-{seq}"
    _pstack().append(pid)
    publish("multiply_begin", dict(fields, product_id=pid))
    return pid


def current_product() -> str | None:
    """The innermost open product id on this thread."""
    st = _pstack()
    return st[-1] if st else None


def end_product(rec: dict | None = None, error: str | None = None, **fields) -> None:
    """Close the innermost product: publish ``multiply_end`` with the
    flight record's duration, algorithm and driver decisions."""
    st = _pstack()
    if not st:
        return
    pid = st[-1]
    args = dict(fields, product_id=pid)
    if rec is not None:
        args["dur_ms"] = rec.get("dur_ms")
        if rec.get("flops") is not None:
            args["flops"] = rec["flops"]
        if rec.get("algorithm"):
            args["algorithm"] = rec["algorithm"]
        if rec.get("drivers"):
            args["drivers"] = {d: v.get("stacks", 0) for d, v in rec["drivers"].items()}
    if error is not None:
        args["error"] = error[:300]
    try:
        publish("multiply_end", args)
    finally:
        if st and st[-1] == pid:
            st.pop()


@contextlib.contextmanager
def product_scope(op: str, name: str, **flight_fields):
    """One correlation scope around a multiply: a product id and a
    flight record, committed and closed on exit; an error stamps both
    and is raised again."""
    pid = begin_product(op=op, name=name)
    _flight.begin(op=op, name=name, product_id=pid, **flight_fields)
    try:
        yield pid
    except Exception as exc:
        err = f"{type(exc).__name__}: {exc}"[:300]
        end_product(rec=_flight.commit(error=err), error=err)
        raise
    end_product(rec=_flight.commit())


def publish(kind: str, args: dict | None = None, *, flight=False) -> dict | None:
    """Publish one event: stamp the open ``product_id`` unless the
    payload has one, forward a flight-recorder event when ``flight`` is
    True (the kind and payload) or a ``(name, fields)`` pair, and append
    ``{"seq", "t", "event": kind, **args}`` to the ring.  Returns the
    ring record (None when the bus is off)."""
    global _seq
    args = args or {}
    if args.get("product_id") is None:
        pid = current_product()
        if pid is not None:
            args = dict(args, product_id=pid)
    if flight:
        if flight is True:
            fname, ffields = kind, {k: v for k, v in args.items() if k != "product_id"}
        else:
            fname, ffields = flight
        _flight.note_event(fname, **ffields)
    if not _enabled:
        return None
    with _lock:
        _seq += 1
        # the envelope's name is "event": a payload's own "kind" (a fault
        # kind, a failure class) must not shadow it
        rec = {"seq": _seq, "t": time.time(), **args, "event": kind}
        rec.setdefault("product_id", None)
        _ring.append(rec)
    for fn in list(_subscribers):
        try:
            fn(rec)
        except Exception:
            pass  # a broken subscriber must not fail the publisher
    return rec


def records(product_id: str | None = None, kind: str | None = None,
            limit: int | None = None) -> list:
    """Ring contents, oldest first, filtered by product id and by the
    envelope's event name."""
    with _lock:
        out = list(_ring)
    if product_id is not None:
        out = [r for r in out if r.get("product_id") == product_id]
    if kind is not None:
        out = [r for r in out if r.get("event") == kind]
    if limit is not None and limit >= 0:
        out = out[-limit:]
    return out


def clear() -> None:
    """Drop the ring (not the product stack: a clear inside a multiply
    must not orphan its id)."""
    with _lock:
        _ring.clear()
