"""Structured-event bus with per-multiply correlation ids.

The subset of `dbcsr_tpu/obs/events.py:99-312` the integrity plane
calls.  `mm.multiply` opens a ``product_id`` per multiply
(`product_scope`: `begin_product`, a flight record, then `end_product`;
nested multiplies form a per-thread stack), and every event published
while it is open carries it.  `publish` appends the event to a bounded
ring (`records`), writes it to the JSONL sink when one is open, forwards
it to the span tracer as an instant and to the flight recorder when
asked (``flight=``), and calls the subscribers.

The sink: ``DBCSR_TPU_TORCH_EVENTS=<base path>`` at import, or
`enable_sink(base)`, streams every record to the process's shard
``<base>.p{index}<ext>`` (`obs.shard`; a provisional name until the
index is known, settled by `rebind` or at close).
``DBCSR_TPU_TORCH_EVENTS=0`` (or ``off``) turns the bus off; then
`publish` only forwards to the tracer and the flight recorder.  The ring
holds ``RING_SIZE`` events.  `end_product` feeds the health model's
windows (`obs.health.observe_multiply`, while the bus is on) and, once
the product popped, the telemetry store's sample boundary
(`obs.timeseries.on_product`).

Stdlib-only.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
import uuid

import atexit
import json

from dbcsr_tpu_torch.obs import flight as _flight
from dbcsr_tpu_torch.obs import shard as _shard
from dbcsr_tpu_torch.obs import tracer as _trace

RING_SIZE = 4096

_lock = threading.Lock()
_env = os.environ.get("DBCSR_TPU_TORCH_EVENTS", "")
_enabled = _env not in ("0", "off")
_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_seq = 0
_subscribers: list = []

# product-id stack, per thread: an event published on another thread
# never takes this thread's open product
_product_tls = threading.local()
_product_seq = 0
_TOKEN = f"{os.getpid():x}-{uuid.uuid4().hex[:6]}"

# the JSONL sink: its open stream (None: no sink), its base path and
# shard path, and whether the shard has its final name
_sink = None
_sink_base: str | None = None
_sink_path: str | None = None
_sink_pid_final = False


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
    publish("multiply_end", args)
    try:
        if _enabled:
            from dbcsr_tpu_torch.obs import health as _health

            _health.observe_multiply(dur_ms=args.get("dur_ms"), error=error)
    except Exception as exc:
        if device_error(exc):
            raise
        # health sampling is bookkeeping: it never fails a multiply
    finally:
        if st and st[-1] == pid:
            st.pop()
    # the product boundary is a telemetry sample boundary, after the pop:
    # a forced sample's health collector must not see this product open
    from dbcsr_tpu_torch.obs import timeseries as _ts

    _ts.on_product()


def device_error(exc: BaseException) -> bool:
    """Whether ``exc`` comes from a kernel or the device (a CUDA error, a
    device out-of-memory, a kernel that failed to build or disagreed with
    its oracle, corrupted output): the obs hooks swallow their own
    bookkeeping errors, never these."""
    if type(exc).__name__ in ("AcceleratorError", "OutOfMemoryError", "BuildError",
                              "KernelValidationError", "CorruptedOutputError",
                              "AbftMismatchError"):
        return True
    msg = str(exc)
    return "CUDA error" in msg or "CUDA driver error" in msg or "CUDA out of memory" in msg


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


def publish(kind: str, args: dict | None = None, *, instant: bool = True,
            flight=False) -> dict | None:
    """Publish one event: stamp the open ``product_id`` unless the
    payload has one, forward a tracer instant of the same name
    (``instant``) and a flight-recorder event when ``flight`` is True
    (the kind and payload) or a ``(name, fields)`` pair, and append
    ``{"seq", "t", "event": kind, **args}`` to the ring and the sink.
    Returns the ring record (None when the bus is off)."""
    global _seq
    args = args or {}
    if args.get("product_id") is None:
        pid = current_product()
        if pid is not None:
            args = dict(args, product_id=pid)
    if instant:
        _trace.instant(kind, args or None)
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
        if _sink is not None:
            try:
                _sink.write(json.dumps(rec, default=str) + "\n")
            except OSError:
                pass  # a full disk must not fail the multiply
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


def to_json(**filters) -> str:
    """`records` (same filters) as one JSON array."""
    return json.dumps(records(**filters), default=str)


def clear() -> None:
    """Drop the ring (not the product stack: a clear inside a multiply
    must not orphan its id)."""
    with _lock:
        _ring.clear()


# ---------------------------------------------------------------- the sink
def sink_active() -> bool:
    return _sink is not None


def sink_path() -> str | None:
    """The open sink's shard file, or None."""
    return _sink_path


def enable_sink(base_path: str | None = None) -> str:
    """Open the JSONL sink at ``base_path`` (default
    ``$DBCSR_TPU_TORCH_EVENTS``), sharded per process; turns the bus on
    and returns the shard's path."""
    global _sink, _sink_base, _sink_path, _sink_pid_final
    base_path = base_path or os.environ.get("DBCSR_TPU_TORCH_EVENTS")
    if not base_path or base_path in ("0", "off"):
        raise ValueError("no events sink path: pass one or set DBCSR_TPU_TORCH_EVENTS")
    disable_sink()
    set_enabled(True)
    pid = _shard.process_index()
    with _lock:
        _sink_base = base_path
        _sink_pid_final = pid is not None
        _sink_path = _shard.shard_path(base_path,
                                       pid if pid is not None else _shard.provisional_tag())
        _sink = open(_sink_path, "a")
    return _sink_path


def disable_sink() -> None:
    """Close the sink, settling a provisional shard on index 0."""
    global _sink
    rebind(force=True)
    with _lock:
        if _sink is not None:
            _sink.close()
            _sink = None


def rebind(process_index: int | None = None, force: bool = False) -> None:
    """Settle a provisional sink shard onto its ``p{index}`` name (the
    rank of a joined `torch.distributed` group, or ``process_index``;
    ``force`` settles on 0)."""
    global _sink, _sink_path, _sink_pid_final
    with _lock:
        if _sink is None or _sink_pid_final:
            return
        if process_index is None:
            process_index = _shard.process_index()
        if process_index is None:
            if not force:
                return
            process_index = 0
        _sink_pid_final = True
        _sink_path, _sink = _shard.settle(_sink_base, _sink_path, _sink, int(process_index))


@atexit.register
def _atexit_close() -> None:  # pragma: no cover - process teardown
    try:
        disable_sink()
    except OSError:
        pass


if _enabled and _env:
    enable_sink(_env)
