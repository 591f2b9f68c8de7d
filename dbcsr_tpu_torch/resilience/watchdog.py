"""Watchdog: one deadline-guarded executor for the calls that can wedge.

Counterpart of `dbcsr_tpu/resilience/watchdog.py`.  In the port it
guards the multi-process world's join (`perf.driver.run_perf_multiproc`,
channel ``mp_world_join``) and the online tuner's trials
(`tune.trials`, channel ``tune_trial``).

Every guarded call classifies into one outcome:

* ``OK``: returned within ``slow_fraction * deadline``;
* ``SLOW``: returned a usable result, but later than that;
* ``TRANSIENT``: raised an ordinary exception (a retry is worthwhile);
* ``WEDGED``: hit the hard deadline (`DeadlineExceeded`,
  `subprocess.TimeoutExpired`, `TimeoutError`).

Backoff: ``delay(streak) = min(base * 2^(streak-1), max) * (1 ± jitter)``
with a per-channel RNG seeded from the name's crc32, so the sequence
replays across processes; the streak counts consecutive non-OK outcomes
and a wedge counts double.  With ``state_path`` every outcome appends a
JSONL record (``ts``, ``name``, ``outcome``, ``streak``,
``wedge_streak``, ``elapsed_s``, ``error``) and a new watchdog resumes
from its channel's last record; past
``DBCSR_TPU_TORCH_WATCHDOG_LOG_MAX_BYTES`` (1 MiB) the file is rotated
down to the last record per channel plus the newest half of the cap.

Each outcome counts in ``dbcsr_tpu_watchdog_outcomes_total{name,outcome}``,
sets ``dbcsr_tpu_watchdog_wedge_streak{name}`` (the health model's
``watchdog`` component) and publishes ``watchdog_outcome``, once the
obs layer is imported.  Stdlib-only; clock, sleep and RNG are
injectable.
"""

from __future__ import annotations

import json
import os
import random
import time
import zlib
from typing import Any, Callable, Optional

OK = "OK"
SLOW = "SLOW"
TRANSIENT = "TRANSIENT"
WEDGED = "WEDGED"

OUTCOMES = (OK, SLOW, TRANSIENT, WEDGED)


class DeadlineExceeded(TimeoutError):
    """A guarded callable overran its hard deadline."""


def rotate_jsonl(path: str, max_bytes: Optional[int] = None) -> bool:
    """Size-capped rotation of an append-only outcome JSONL (one row
    per guarded attempt, without bound otherwise).  When ``path`` exceeds
    ``max_bytes`` (``DBCSR_TPU_TORCH_WATCHDOG_LOG_MAX_BYTES``, default
    1 MiB), rewrite it keeping

    * the LAST record of every ``name`` — `_resume` scans for exactly
      these, so every channel's live streak/backoff state survives the
      rotation — plus
    * the newest tail of rows up to half the cap (recent history for
      `tools/doctor.py` and humans).

    Atomic (write-temp + rename), torn tail lines tolerated, and never
    raises: rotation is bookkeeping, not an outcome."""
    if max_bytes is None:
        try:
            max_bytes = int(os.environ.get(
                "DBCSR_TPU_TORCH_WATCHDOG_LOG_MAX_BYTES", 1 << 20))
        except ValueError:
            max_bytes = 1 << 20
    try:
        if max_bytes <= 0 or os.path.getsize(path) <= max_bytes:
            return False
        with open(path) as fh:
            lines = fh.readlines()
    except OSError:
        return False
    last_by_name: dict = {}
    for i, line in enumerate(lines):
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        name = rec.get("name")
        if name:
            last_by_name[name] = i
    keep = set(last_by_name.values())
    budget = max_bytes // 2
    size = 0
    for i in range(len(lines) - 1, -1, -1):
        size += len(lines[i])
        if size > budget:
            break
        keep.add(i)
    tmp = path + ".rot"
    try:
        with open(tmp, "w") as fh:
            fh.writelines(lines[i] for i in sorted(keep))
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False
    return True


class WatchdogResult:
    """Outcome of one guarded call (or one retry loop)."""

    __slots__ = ("outcome", "value", "elapsed_s", "attempts", "error")

    def __init__(self, outcome: str, value: Any = None,
                 elapsed_s: float = 0.0, attempts: int = 1,
                 error: Optional[str] = None):
        self.outcome = outcome
        self.value = value
        self.elapsed_s = elapsed_s
        self.attempts = attempts
        self.error = error

    @property
    def ok(self) -> bool:
        return self.outcome in (OK, SLOW)

    def __repr__(self):
        return (f"WatchdogResult({self.outcome}, attempts={self.attempts}, "
                f"elapsed={self.elapsed_s:.3f}s, error={self.error!r})")


def _timeout_types() -> tuple:
    import subprocess

    return (DeadlineExceeded, subprocess.TimeoutExpired, TimeoutError)


class Watchdog:
    """Deadline-guarded executor with backoff memory for one named
    hardware channel (e.g. ``mp_world_join``, ``tune_trial``)."""

    def __init__(self, name: str, deadline_s: float,
                 slow_fraction: float = 0.5,
                 backoff_base_s: float = 60.0,
                 backoff_max_s: float = 3600.0,
                 jitter: float = 0.1,
                 state_path: Optional[str] = None,
                 clock=time.monotonic, sleep=time.sleep,
                 rng: Optional[random.Random] = None,
                 resume: bool = True):
        self.name = name
        self.deadline_s = float(deadline_s)
        self.slow_fraction = slow_fraction
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.jitter = jitter
        self.state_path = state_path
        self.clock = clock
        self.sleep = sleep
        # crc32, not hash(): str hashing is salted per process, and the
        # jitter sequence must replay across runs (the same determinism
        # contract as the faults layer)
        self.rng = rng if rng is not None else random.Random(
            zlib.crc32(name.encode()))
        self.streak = 0        # consecutive non-OK outcomes
        self.wedge_streak = 0  # consecutive WEDGED outcomes
        self.last_outcome: Optional[str] = None
        # resume=False: persist outcomes but skip the state-file scan —
        # for one-shot guards that never consult next_delay()
        if state_path and resume:
            self._resume()

    # -- persistence -----------------------------------------------------

    def _resume(self) -> None:
        """Reload the last persisted outcome for this name (torn tail
        lines tolerated)."""
        try:
            with open(self.state_path) as fh:
                for line in fh:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("name") == self.name:
                        self.streak = int(rec.get("streak", 0))
                        self.wedge_streak = int(rec.get("wedge_streak", 0))
                        self.last_outcome = rec.get("outcome")
        except OSError:
            pass

    def _persist(self, result: WatchdogResult) -> None:
        if not self.state_path:
            return
        rec = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "name": self.name,
            "outcome": result.outcome,
            "streak": self.streak,
            "wedge_streak": self.wedge_streak,
            "elapsed_s": round(result.elapsed_s, 3),
            "error": result.error,
        }
        try:
            with open(self.state_path, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
        except OSError:
            return
        # bound the append-only log; the just-written record is by
        # definition the newest, so the streak state always survives
        rotate_jsonl(self.state_path)

    # -- observability ---------------------------------------------------

    def _emit(self, result: WatchdogResult) -> None:
        import sys

        if "dbcsr_tpu_torch.obs.metrics" not in sys.modules:
            # never the cause of the first `dbcsr_tpu_torch.obs` import:
            # an environment-activated trace session must not open its
            # shards in a process that only guards a subprocess
            return
        try:
            from dbcsr_tpu_torch.obs import events as _events
            from dbcsr_tpu_torch.obs import metrics as _metrics

            _metrics.counter(
                "dbcsr_tpu_watchdog_outcomes_total",
                "guarded hardware-call outcomes per watchdog channel",
            ).inc(name=self.name, outcome=result.outcome)
            _metrics.gauge(
                "dbcsr_tpu_watchdog_wedge_streak",
                "consecutive WEDGED outcomes per watchdog channel",
            ).set(self.wedge_streak, name=self.name)
            _events.publish("watchdog_outcome", {
                "name": self.name, "outcome": result.outcome,
                "elapsed_s": round(result.elapsed_s, 3),
                "streak": self.streak,
                "wedge_streak": self.wedge_streak,
                "error": result.error,
            })
        except Exception:
            pass

    # -- core ------------------------------------------------------------

    def classify(self, elapsed_s: float, error: Optional[BaseException]) -> str:
        """The outcome taxonomy (module docstring), as a pure function
        so tests can pin it."""
        if error is not None:
            if isinstance(error, _timeout_types()):
                return WEDGED
            return TRANSIENT
        if elapsed_s > self.slow_fraction * self.deadline_s:
            return SLOW
        return OK

    def guard(self, fn: Callable[[float], Any]) -> WatchdogResult:
        """One guarded attempt.  ``fn`` receives the deadline (seconds)
        and must enforce it itself (subprocess timeout, socket timeout,
        …), raising `DeadlineExceeded` / `subprocess.TimeoutExpired` on
        overrun — the watchdog cannot preempt arbitrary in-process code,
        it classifies and keeps the streak book."""
        t0 = self.clock()
        error: Optional[BaseException] = None
        value = None
        try:
            value = fn(self.deadline_s)
        except BaseException as exc:  # noqa: BLE001 — classified below
            if isinstance(exc, (KeyboardInterrupt, SystemExit)):
                raise
            error = exc
        elapsed = self.clock() - t0
        outcome = self.classify(elapsed, error)
        if outcome == OK:
            self.streak = 0
            self.wedge_streak = 0
        else:
            self.streak += 1
            if outcome == WEDGED:
                self.wedge_streak += 1
            else:
                self.wedge_streak = 0
        self.last_outcome = outcome
        result = WatchdogResult(
            outcome, value=value, elapsed_s=elapsed,
            error=None if error is None else
            f"{type(error).__name__}: {error}",
        )
        self._emit(result)
        self._persist(result)
        return result

    def next_delay(self) -> float:
        """Backoff delay before the next attempt, from the current
        streak (0 → base cadence; wedges escalate exponentially)."""
        streak = max(self.streak, self.wedge_streak * 2)
        delay = min(self.backoff_base_s * (2 ** max(streak - 1, 0)),
                    self.backoff_max_s) if streak else self.backoff_base_s
        if self.jitter:
            delay *= 1.0 + self.jitter * (2.0 * self.rng.random() - 1.0)
        return delay

    def run(self, fn: Callable[[float], Any], retries: int = 0,
            retry_on=(TRANSIENT, WEDGED)) -> WatchdogResult:
        """Guarded call with up to ``retries`` backoff retries on the
        given outcome classes.  Returns the LAST attempt's result with
        ``attempts`` stamped."""
        attempts = 0
        while True:
            attempts += 1
            result = self.guard(fn)
            result.attempts = attempts
            if result.outcome not in retry_on or attempts > retries:
                return result
            self.sleep(self.next_delay())


def run_guarded(name: str, fn: Callable[[float], Any], deadline_s: float,
                **kwargs) -> WatchdogResult:
    """One-shot convenience: build a Watchdog, guard one call."""
    return Watchdog(name, deadline_s, **kwargs).guard(fn)
