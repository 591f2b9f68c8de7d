"""Per-multiply flight recorder: a bounded ring of the last products.

Counterpart of `dbcsr_tpu/obs/flight.py`.  Every `multiply` opens a
record (`begin`, through `obs.events.product_scope`), the engine and the
integrity plane fill it (`note`, `note_driver`, `note_event`: injected
faults, driver failures, failovers, breaker transitions, ABFT mismatches
and recoveries, chain rollbacks), and `commit` stamps its duration and
the memory high-water (`core.stats.memory_high_water`), appends it to a
ring of the last ``RING_SIZE`` products and folds it into the profile
epochs (`obs.profiler.observe`).  Records nest (a TAS split runs
multiplies inside a contraction).  `dump` prints the ring and writes it
as JSON.

The port's record carries the multiply's host seconds per phase
(``phases_ms``, from ``c._mm_phase_s``) instead of the JAX package's
timer deltas.

Stdlib-only at import.
"""

from __future__ import annotations

import collections
import json
import sys
import time

RING_SIZE = 32
_MAX_EVENTS_PER_RECORD = 64

_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_current: list = []  # stack of open records (nested multiplies)
_seq = 0


def ring_capacity() -> int:
    return _ring.maxlen


def begin(**fields) -> dict:
    """Open a record for the multiply that is starting."""
    global _seq
    _seq += 1
    rec = {"seq": _seq, "t_unix": time.time(), "drivers": {}, **fields}
    rec["_t0"] = time.perf_counter()
    _current.append(rec)
    return rec


def note(key: str, value) -> None:
    """Set a field on the innermost open record (no-op outside one)."""
    if _current:
        _current[-1][key] = value


def note_driver(driver: str, why: str, mnk=None, entries: int = 0) -> None:
    """Accumulate one stack-driver decision onto the open record."""
    if not _current:
        return
    d = _current[-1]["drivers"].setdefault(driver, {"stacks": 0, "entries": 0, "why": why})
    d["stacks"] += 1
    d["entries"] += entries
    if mnk is not None:
        d.setdefault("mnk", []).append(list(mnk))


def note_event(event: str, **fields) -> None:
    """Append one structured event to the innermost open record's bounded
    ``events`` list; overflow drops the oldest, and ``events_total``
    keeps the true count.  No-op outside a record."""
    if not _current:
        return
    rec = _current[-1]
    events = rec.setdefault("events", [])
    rec["events_total"] = rec.get("events_total", 0) + 1
    if len(events) >= _MAX_EVENTS_PER_RECORD:
        del events[0]
    events.append(dict(fields, event=event))


def commit(error: str | None = None) -> dict | None:
    """Close the innermost record: stamp its duration (and ``error``),
    append it to the ring and return it."""
    if not _current:
        return None
    rec = _current.pop()
    rec["dur_ms"] = round((time.perf_counter() - rec.pop("_t0")) * 1e3, 3)
    if error is not None:
        rec["error"] = error
    from dbcsr_tpu_torch.core import stats
    from dbcsr_tpu_torch.obs import profiler

    rec["memory"] = stats.memory_high_water()
    _ring.append(rec)
    profiler.observe(rec)
    return rec


def records() -> list:
    """Ring contents, oldest first."""
    return list(_ring)


def clear() -> None:
    _ring.clear()
    _current.clear()


def to_json() -> str:
    return json.dumps(records(), default=str)


def dump(path: str | None = None, out=None) -> None:
    """Print the ring, newest last (to stderr unless ``out`` is given),
    one line per multiply; ``path`` also receives the full JSON."""
    if out is None:
        def out(line):
            print(line, file=sys.stderr)
    recs = records()
    out(f" FLIGHT RECORDER -- last {len(recs)} multiplies (capacity {_ring.maxlen})")
    for r in recs:
        mnk = r.get("mnk") or (r.get("m", "?"), r.get("n", "?"), r.get("k", "?"))
        drv = ",".join(f"{d}x{v['stacks']}({v['why']})"
                       for d, v in sorted(r.get("drivers", {}).items())) or r.get("algorithm", "-")
        phases = " ".join(f"{k}={v:.1f}" for k, v in (r.get("phases_ms") or {}).items())
        err = f"  ERROR={r['error']}" if r.get("error") else ""
        if r.get("events"):
            kinds = ",".join(sorted({e["event"] for e in r["events"]}))
            err += f"  events={len(r['events'])}({kinds})"
        out(f"  #{r['seq']} {r.get('name', '?')} {mnk[0]}x{mnk[1]}x{mnk[2]} "
            f"alg={r.get('algorithm', '?')} drivers=[{drv}] eps={r.get('filter_eps')} "
            f"{r.get('dur_ms', 0):.1f} ms [{phases}]{err}")
    if path:
        with open(path, "w") as f:
            f.write(to_json())
        out(f"  (full JSON written to {path})")
