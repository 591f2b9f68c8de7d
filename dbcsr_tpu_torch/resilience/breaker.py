"""Per-(driver, shape-key) circuit breakers for the stack-driver chain.

A copy of `dbcsr_tpu/resilience/breaker.py`: a closed -> open ->
half-open breaker per (driver, shape key), the driver being the
config's name ("pallas_cross", "pallas", "torch", "host") and the key
(m, n, k, dtype).

* **closed**: launches flow; ``fail_threshold`` consecutive failures
  (default 3, ``DBCSR_TPU_TORCH_BREAKER_THRESHOLD``) trip it open, and a
  ``validation`` failure (a kernel proven wrong against the host oracle)
  trips it at once.
* **open**: `allow` is False until ``cooldown_s`` (default 30,
  ``DBCSR_TPU_TORCH_BREAKER_COOLDOWN_S``) has passed, so the stack goes
  down the failover chain without paying the failure again.
* **half-open**: after the cooldown one trial launch is let through;
  success closes the breaker, failure opens it again with the cooldown
  doubled (at most 16 times the base).

Every transition refreshes the ``dbcsr_tpu_breaker_state{driver,shape}``
gauge (0 closed, 1 half-open, 2 open) and publishes a
``breaker_transition`` event with a flight note.  `acc.smm.execute_stack`
calls `allow` before a launch and `record_failure`/`record_success`
after it.  The JAX package's ``fused`` pseudo-driver has no counterpart
yet (no superstack).

Stdlib-only; the clock is injectable for tests.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Tuple

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

# failure kinds whose first occurrence trips the breaker straight open:
# a validation failure is proven numeric corruption (the host-oracle
# gate), never worth two more tries on live data
_HARD_KINDS = ("validation",)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class Breaker:
    """One (driver, shape-key) breaker.  Not thread-safe on its own —
    the board serializes access."""

    __slots__ = ("state", "failures", "successes", "opened_at",
                 "cooldown_s", "base_cooldown_s", "last_kind", "trips")

    def __init__(self, cooldown_s: float):
        self.state = CLOSED
        self.failures = 0       # consecutive, since last success
        self.successes = 0
        self.opened_at = 0.0
        self.base_cooldown_s = cooldown_s
        self.cooldown_s = cooldown_s
        self.last_kind: Optional[str] = None
        self.trips = 0


class BreakerBoard:
    """Registry of breakers keyed by (driver, shape_key)."""

    def __init__(self, fail_threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None, clock=time.monotonic):
        self.fail_threshold = (
            fail_threshold if fail_threshold is not None
            else _env_int("DBCSR_TPU_TORCH_BREAKER_THRESHOLD", 3))
        self.cooldown_s = (
            cooldown_s if cooldown_s is not None
            else _env_float("DBCSR_TPU_TORCH_BREAKER_COOLDOWN_S", 30.0))
        self.clock = clock
        self._lock = threading.Lock()
        self._breakers: Dict[Tuple[str, tuple], Breaker] = {}

    # -- observability ---------------------------------------------------

    def _emit(self, driver: str, key, br: Breaker, transition: str) -> None:
        try:
            from dbcsr_tpu_torch.obs import events as _events
            from dbcsr_tpu_torch.obs import metrics as _metrics

            shape = "x".join(str(x) for x in key) if key else "-"
            _metrics.gauge(
                "dbcsr_tpu_breaker_state",
                "circuit-breaker state per (driver, shape): 0=closed, "
                "1=half_open, 2=open",
            ).set(_STATE_CODE[br.state], driver=driver, shape=shape)
            # one publish gives the bus record and the flight event
            # (correlated to the open multiply's product_id)
            _events.publish(
                "breaker_transition",
                {"driver": driver, "shape": shape, "to": br.state,
                 "transition": transition, "failures": br.failures,
                 "kind": br.last_kind},
                flight=("breaker", {"driver": driver, "shape": shape,
                                    "to": br.state, "why": transition}),
            )
        except Exception:
            pass  # observability must never fail a launch

    # -- core protocol ---------------------------------------------------

    def _get(self, driver: str, key) -> Breaker:
        k = (driver, tuple(key) if key is not None else ())
        br = self._breakers.get(k)
        if br is None:
            br = self._breakers[k] = Breaker(self.cooldown_s)
        return br

    def allow(self, driver: str, key) -> bool:
        """May this driver launch this shape now?  Open breakers whose
        cooldown elapsed move to half-open and admit ONE trial."""
        if not self._breakers:  # fast path: nothing ever failed
            return True
        with self._lock:
            k = (driver, tuple(key) if key is not None else ())
            br = self._breakers.get(k)
            if br is None or br.state == CLOSED:
                return True
            if br.state == HALF_OPEN:
                # one trial is already in flight this period; further
                # launches keep falling down the chain
                return False
            if self.clock() - br.opened_at >= br.cooldown_s:
                br.state = HALF_OPEN
                self._emit(driver, k[1], br, "cooldown-elapsed")
                return True
            return False

    def record_success(self, driver: str, key) -> None:
        if not self._breakers:
            return
        with self._lock:
            k = (driver, tuple(key) if key is not None else ())
            br = self._breakers.get(k)
            if br is None:
                return
            br.successes += 1
            br.failures = 0
            if br.state != CLOSED:
                br.state = CLOSED
                br.cooldown_s = br.base_cooldown_s
                self._emit(driver, k[1], br, "trial-succeeded")

    def record_failure(self, driver: str, key, kind: str = "runtime") -> None:
        with self._lock:
            br = self._get(driver, key)
            br.failures += 1
            br.last_kind = kind
            if br.state == HALF_OPEN:
                # the trial failed: re-open, back off harder
                br.state = OPEN
                br.opened_at = self.clock()
                br.cooldown_s = min(br.cooldown_s * 2,
                                    br.base_cooldown_s * 16)
                br.trips += 1
                self._emit(driver, key, br, "trial-failed")
            elif br.state == CLOSED and (
                    kind in _HARD_KINDS
                    or br.failures >= self.fail_threshold):
                br.state = OPEN
                br.opened_at = self.clock()
                br.trips += 1
                self._emit(driver, key, br,
                           "hard-failure" if kind in _HARD_KINDS
                           else "threshold")
            else:
                self._emit(driver, key, br, "failure-recorded")

    def state(self, driver: str, key) -> str:
        with self._lock:
            br = self._breakers.get(
                (driver, tuple(key) if key is not None else ()))
            return br.state if br is not None else CLOSED

    def snapshot(self) -> dict:
        """{driver|shape: {state, failures, trips, cooldown_s}} for
        dumps and tests."""
        with self._lock:
            return {
                f"{drv}|{'x'.join(str(x) for x in key) or '-'}": {
                    "state": br.state, "failures": br.failures,
                    "successes": br.successes, "trips": br.trips,
                    "cooldown_s": br.cooldown_s, "last_kind": br.last_kind,
                }
                for (drv, key), br in self._breakers.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._breakers.clear()


_board: Optional[BreakerBoard] = None
_board_lock = threading.Lock()


def get_board() -> BreakerBoard:
    """The process-wide board `acc.smm` wires through (tests build
    their own with a fake clock)."""
    global _board
    if _board is None:
        with _board_lock:
            if _board is None:
                _board = BreakerBoard()
    return _board


def reset_board() -> None:
    """Drop all breaker state (tests; paired with metrics.reset)."""
    global _board
    with _board_lock:
        _board = None
