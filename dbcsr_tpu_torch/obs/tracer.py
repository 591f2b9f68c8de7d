"""Span tracer with a JSONL stream and a Chrome-trace export.

Counterpart of `dbcsr_tpu/obs/tracer.py`.  Every `core.timings.timed`
region becomes a span (name, start, duration, nesting depth, process
index, thread) with the attributes the engine attaches while it is open
(`annotate`, `add`: the product's m, n, k, the stacks' entries), and the
engine's events become instants (`instant`: each stack's mnk, entries
and driver, the event bus's records).  One event stream, two exports:

* **JSONL**, written line by line while the run executes (what
  completed is on disk if the process dies);
* **Chrome** ``trace_event`` JSON, written on `flush`, `disable` and at
  exit next to the JSONL as ``<shard>.chrome.json``; it loads in
  Perfetto, and its spans carry the names of the `torch.profiler`
  ranges `timed` opens (``dbcsr_tpu_torch:<name>``), so host phases
  and the card's kernels line up.

Both stamp events on `torch.profiler`'s clock: microseconds of
CLOCK_REALTIME (``time.time_ns``), the clock of its events' ``start_ns``
(a `torch.profiler` Chrome export subtracts its ``baseTimeNanoseconds``).
The offset to the monotonic ``perf_counter`` is taken once, at `enable`.
`tools/trace_merge.py` puts the shards of a world on one timeline by
their ``clock_align`` instants (`parallel.multihost` publishes one at
the join); it keeps a shard's own stamps where the shard is merged
alone.  Shards without the instant, merged together, it would shift
by their ``t0_unix`` though their stamps already are on the wall clock.

The configured path is a base: the stream writes the process's shard
``<base>.p{index}<ext>`` (`obs.shard`), under a provisional name until
the index is known (`rebind`, `flush` or the close settle it).

Activation: ``DBCSR_TPU_TORCH_TRACE=<path>`` at import, or
`enable(path)`.  Off, each call site costs one ``is None`` check.
Stdlib-only: `core.timings` and `core.stats` import it.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time

from dbcsr_tpu_torch.obs import shard as _shard

# events kept in memory for the Chrome export (the JSONL is unbounded)
_MAX_EVENTS = 500_000

# the active tracer, or None: the one attribute the call sites check
_tracer = None
_lock = threading.Lock()


def _json_default(o):
    return str(o)


shard_path = _shard.shard_path


class Tracer:
    """One trace session: the open JSONL shard and the in-memory events
    the Chrome export is built from.  ``path`` is the base path."""

    def __init__(self, path: str):
        self.base_path = path
        self.events: list = []
        self.dropped = 0
        self._t0 = time.perf_counter()
        self._t0_us = time.time_ns() / 1e3  # `_t0` on the profiler's clock
        self._span_stack: list = []  # [name, t_start_us, attrs]
        pid = _shard.process_index()
        self._pid_final = pid is not None
        self.process_index = pid or 0
        self.path = shard_path(path, pid if self._pid_final else _shard.provisional_tag())
        self.chrome_path = self.path + ".chrome.json"
        self._fh = open(self.path, "a")
        self._emit({"ev": "meta", "t0_unix": self._t0_us / 1e6, "pid": self.process_index,
                    "base_path": os.path.basename(path), "clock": "unix_us"})

    def now_us(self) -> float:
        """Now on the profiler's clock (see the module's docstring)."""
        return (time.perf_counter() - self._t0) * 1e6 + self._t0_us

    def begin(self, name: str, t_us: float | None = None) -> None:
        self._span_stack.append([name, self.now_us() if t_us is None else t_us, None])

    def end(self, name: str, dur_s: float | None = None) -> None:
        if not self._span_stack:
            return
        ent = self._span_stack.pop()
        if ent[0] != name:
            return  # a mismatched stop: drop the span, keep the trace sound
        dur_us = dur_s * 1e6 if dur_s is not None else self.now_us() - ent[1]
        rec = {"ev": "span", "name": name, "ts_us": round(ent[1], 1),
               "dur_us": round(dur_us, 1), "depth": len(self._span_stack),
               "pid": self.process_index, "tid": threading.get_ident() % 10**6}
        if ent[2]:
            rec["attrs"] = ent[2]
        self._emit(rec)

    def annotate(self, **attrs) -> None:
        """Attach attributes to the innermost open span."""
        if not self._span_stack:
            return
        top = self._span_stack[-1]
        if top[2] is None:
            top[2] = {}
        top[2].update(attrs)

    def add(self, key: str, value) -> None:
        """Add a number to an attribute of the innermost open span."""
        if not self._span_stack:
            return
        top = self._span_stack[-1]
        if top[2] is None:
            top[2] = {}
        top[2][key] = top[2].get(key, 0) + value

    def instant(self, name: str, args: dict | None = None) -> None:
        rec = {"ev": "instant", "name": name, "ts_us": round(self.now_us(), 1),
               "pid": self.process_index, "tid": threading.get_ident() % 10**6}
        if args:
            rec["args"] = args
        self._emit(rec)

    def _emit(self, rec: dict) -> None:
        self._fh.write(json.dumps(rec, default=_json_default) + "\n")
        if len(self.events) < _MAX_EVENTS:
            self.events.append(rec)
        else:
            self.dropped += 1

    def _finalize_pid(self, pid: int | None = None, force: bool = False) -> None:
        """Move a provisional shard to its ``p{index}`` name once the
        index is known (``pid`` given, or a joined `torch.distributed`
        group); ``force`` settles on 0."""
        if self._pid_final:
            return
        if pid is None:
            pid = _shard.process_index()
        if pid is None:
            if not force:
                return
            pid = 0
        self._pid_final = True
        self.process_index = int(pid)
        new_path, fh = _shard.settle(self.base_path, self.path, self._fh, int(pid))
        if fh is not self._fh:
            self._fh = fh
            self.path = new_path
            self.chrome_path = new_path + ".chrome.json"
        for rec in self.events:
            rec["pid"] = self.process_index
        self._emit({"ev": "meta", "pid": self.process_index, "note": "process index resolved"})

    def flush(self) -> None:
        """Flush the JSONL stream and (re)write the Chrome trace."""
        self._finalize_pid()
        self._fh.flush()
        write_chrome_trace(self.chrome_path, self.events, dropped=self.dropped)

    def close(self) -> None:
        self._finalize_pid(force=True)
        if self.dropped:
            self._emit({"ev": "meta", "dropped_events": self.dropped})
        self.flush()
        self._fh.close()


def chrome_events(events: list) -> list:
    """The native records as Chrome ``trace_event`` dicts: complete
    events (``X``) for spans, instants (``i``) for instants."""
    out = []
    for rec in events:
        ev = rec.get("ev")
        if ev == "span":
            ce = {"name": rec["name"], "cat": "dbcsr_tpu", "ph": "X", "ts": rec["ts_us"],
                  "dur": rec["dur_us"], "pid": rec["pid"], "tid": rec.get("tid", 0)}
            if rec.get("attrs"):
                ce["args"] = rec["attrs"]
            out.append(ce)
        elif ev == "instant":
            ce = {"name": rec["name"], "cat": "dbcsr_tpu", "ph": "i", "s": "t",
                  "ts": rec["ts_us"], "pid": rec["pid"], "tid": rec.get("tid", 0)}
            if rec.get("args"):
                ce["args"] = rec["args"]
            out.append(ce)
    return out


def write_chrome_trace(path: str, events: list, dropped: int = 0) -> None:
    doc = {"traceEvents": chrome_events(events), "displayTimeUnit": "ms",
           "otherData": {"producer": "dbcsr_tpu_torch.obs.tracer", "dropped_events": dropped}}
    with open(path, "w") as f:
        json.dump(doc, f, default=_json_default)


def enable(path: str | None = None) -> Tracer:
    """Start tracing to ``path`` (default ``$DBCSR_TPU_TORCH_TRACE``),
    closing any active session; the stream's file is the returned
    tracer's ``.path``."""
    global _tracer
    path = path or os.environ.get("DBCSR_TPU_TORCH_TRACE")
    if not path:
        raise ValueError("no trace path: pass one or set DBCSR_TPU_TORCH_TRACE")
    with _lock:
        if _tracer is not None:
            _tracer.close()
        _tracer = Tracer(path)
    return _tracer


def disable() -> None:
    """Stop tracing: flush the JSONL and write the Chrome trace."""
    global _tracer
    with _lock:
        if _tracer is not None:
            _tracer.close()
            _tracer = None


def active() -> bool:
    return _tracer is not None


def rebind(process_index: int | None = None) -> None:
    """Settle the active shard onto its final ``p{index}`` name (no-op
    when tracing is off or the index is settled)."""
    t = _tracer
    if t is not None:
        t._finalize_pid(pid=process_index)


def get() -> Tracer | None:
    return _tracer


def annotate(**attrs) -> None:
    t = _tracer
    if t is not None:
        t.annotate(**attrs)


def add(key: str, value) -> None:
    t = _tracer
    if t is not None:
        t.add(key, value)


def instant(name: str, args: dict | None = None) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, args)


@atexit.register
def _atexit_flush() -> None:  # pragma: no cover - process teardown
    t = _tracer
    if t is not None:
        try:
            t.close()
        except OSError:
            pass


if os.environ.get("DBCSR_TPU_TORCH_TRACE"):
    enable(os.environ["DBCSR_TPU_TORCH_TRACE"])
