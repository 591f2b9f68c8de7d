"""Admission-controlled priority queue for the serving plane.

Counterpart of `dbcsr_tpu/serve/queue.py`.  Every submission passes
three gates, in order:

1. **Fault site** ``serve_admit`` (`resilience.faults`): an injected
   fault sheds the request with a structured rejection.
2. **Health** (`obs.health.admission_status`): CRITICAL sheds (requests
   in flight keep draining: admission is the only thing that closes);
   DEGRADED queues with an enforced deadline (the request's own, or
   ``serve_degraded_deadline_s``); OK admits.
3. **Quotas**: the global queue bound (``serve_queue_max``), the
   per-tenant count of queued and running requests
   (``serve_tenant_inflight``) and queued operand bytes
   (``serve_tenant_bytes``).

Every shed is observable the same way: a `Rejected` carrying a
machine-readable reason, a ``serve_shed`` bus event with the
``request_id`` and ``tenant``, the ``dbcsr_tpu_serve_shed_total``
counter, and a `health.observe_serve` sample for the shed-storm
detector.

Requests that expire while queued are dropped at pop time as
``WEDGED`` (they never ran); finished requests classify ``OK``, ``SLOW``
(past the deadline) or ``TRANSIENT`` (failed): the watchdog's taxonomy
at request granularity.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
import uuid
from typing import Optional

from dbcsr_tpu_torch.resilience import faults as _faults
from dbcsr_tpu_torch.resilience.watchdog import OK, SLOW, TRANSIENT, WEDGED
from dbcsr_tpu_torch.utils import lockcheck as _lockcheck

_req_seq = itertools.count(1)
_TOKEN = uuid.uuid4().hex[:6]

# terminal request states ("journaled": accepted work persisted to the
# drain journal for replay after restart — terminal in THIS process)
DONE_STATES = ("done", "failed", "shed", "deadline_missed", "journaled")


class Rejected(RuntimeError):
    """Structured admission rejection: ``reason`` is machine-readable
    (``critical``/``queue_full``/``quota_inflight``/``quota_bytes``/
    ``fault``), ``detail`` human-readable."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason
        self.detail = detail


class Request:
    """One submitted product: the queue entry AND the client's ticket.

    Clients block on `wait()`; the engine moves ``state`` through
    queued -> running -> done/failed (or shed/deadline_missed straight
    from admission/expiry) and classifies ``outcome`` with the
    watchdog taxonomy."""

    __slots__ = (
        "request_id", "session", "op", "params", "priority", "t_submit",
        "t_deadline", "t_done", "t_running", "state", "outcome", "error",
        "result", "ckey", "nbytes", "journal", "replay_journal_path",
        "journal_wal", "on_terminal", "ready", "_event",
    )

    def __init__(self, session, op: str, params: dict,
                 priority: int = 10, deadline_s: Optional[float] = None,
                 request_id: Optional[str] = None):
        # an explicit request_id preserves identity across a drain ->
        # journal -> restart -> replay cycle (idempotency contract,
        # docs/serving.md § Drain & restart)
        self.request_id = request_id or f"req-{_TOKEN}-{next(_req_seq)}"
        self.session = session
        self.op = op
        self.params = params
        self.priority = int(priority)
        self.t_submit = time.time()
        self.t_deadline = (self.t_submit + float(deadline_s)
                           if deadline_s is not None else None)
        self.t_done: Optional[float] = None
        self.t_running: Optional[float] = None  # stamped at pop (the
        #                       queued -> running edge the attribution
        #                       ledger turns into the "queued" phase)
        self.state = "new"
        self.outcome: Optional[str] = None
        self.error: Optional[str] = None
        self.result: Optional[dict] = None
        self.ckey = None      # coalesce key (engine fills at submit)
        self.nbytes = 0       # operand bytes estimate (quota accounting)
        self.journal = None   # JSON-safe resubmission record (engine
        #                       fills at submit when params are by-name)
        self.replay_journal_path: Optional[str] = None  # set when this
        #                       request was resubmitted from a drain
        #                       journal: its terminal state appends a
        #                       completion tombstone there
        self.journal_wal = False  # write-ahead journaled at SUBMIT
        #                       (DBCSR_TPU_TORCH_SERVE_WAL): unlike a drain
        #                       replay, a shed IS terminal for the line
        #                       — the routed submitter observed it and
        #                       owns the retry
        self.on_terminal = None  # engine hook invoked by _finish with
        #                       (request, state) BEFORE the terminal
        #                       state becomes visible — the one
        #                       chokepoint every terminal transition
        #                       (done/failed/deadline_missed/...) runs
        #                       through, so a replayed request cannot
        #                       reach ANY end state untombstoned
        self.ready = None  # CUDA event: the operands are complete
        self._event = threading.Event()

    @property
    def tenant(self) -> str:
        return self.session.tenant

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request reached a terminal state."""
        return self._event.wait(timeout)

    @property
    def done(self) -> bool:
        return self.state in DONE_STATES

    def _finish(self, state: str, outcome: Optional[str] = None,
                error: Optional[str] = None,
                result: Optional[dict] = None) -> None:
        if self.on_terminal is not None:
            cb, self.on_terminal = self.on_terminal, None
            try:
                cb(self, state)
            except Exception:
                pass  # a journal hiccup must never mask the outcome
        # the attribution ledger's terminal chokepoint — a direct
        # guarded call, NOT the on_terminal slot (that is the journal
        # replay's single-consumer tombstone hook)
        try:
            import sys

            _attr = sys.modules.get("dbcsr_tpu_torch.obs.attribution")
            if _attr is not None:
                _attr.on_terminal(self, state)
        except Exception:
            pass  # bookkeeping must never mask the outcome
        self.state = state
        self.outcome = outcome
        self.error = error
        self.result = result
        self.t_done = time.time()
        # workload-trace recorder (off unless DBCSR_TPU_TORCH_WORKLOAD is
        # set): runs AFTER the terminal fields land so the record
        # carries the classified outcome; same guarded-module pattern
        # as the attribution ledger above
        try:
            import sys

            _wl = sys.modules.get("dbcsr_tpu_torch.serve.workload")
            if _wl is not None:
                _wl.on_terminal(self, state)
        except Exception:
            pass  # recording must never mask the outcome
        self._event.set()

    def info(self) -> dict:
        """JSON-safe status payload (the ``/serve/status`` shape)."""
        out = {
            "request_id": self.request_id,
            "tenant": self.tenant,
            "session": self.session.session_id,
            "op": self.op,
            "priority": self.priority,
            "state": self.state,
            "outcome": self.outcome,
            "error": self.error,
            "result": self.result,
            "t_submit": self.t_submit,
            "t_deadline": self.t_deadline,
            "latency_ms": (round((self.t_done - self.t_submit) * 1e3, 3)
                           if self.t_done else None),
        }
        try:
            import sys

            _attr = sys.modules.get("dbcsr_tpu_torch.obs.attribution")
            if _attr is not None:
                out["attribution"] = _attr.request_info(self.request_id)
        except Exception:
            pass  # the base payload stands on its own
        return out

    def __repr__(self):
        return (f"Request({self.request_id}, {self.op}, "
                f"tenant={self.tenant!r}, state={self.state})")


def classify(req: Request) -> str:
    """Watchdog-taxonomy outcome for a request that finished running:
    OK within deadline, SLOW past it, TRANSIENT on failure (WEDGED is
    reserved for requests that expired before running)."""
    if req.error is not None:
        return TRANSIENT
    if req.t_deadline is not None and time.time() > req.t_deadline:
        return SLOW
    return OK


class AdmissionQueue:
    """Bounded priority queue with the admission pipeline of the
    module docstring.  ``priority`` sorts ascending (lower = sooner);
    ties pop in submit order."""

    def __init__(self):
        self._lock = _lockcheck.wrap("serve.queue", threading.Lock())
        self._cond = threading.Condition(self._lock)
        self._heap: list = []
        self._seq = itertools.count()
        # per-tenant accounting: queued+running request counts and
        # queued operand bytes (the two quota dimensions)
        self._tenant_count: dict = {}
        self._tenant_bytes: dict = {}
        # admission gate: a non-None reason sheds every new submission
        # with that structured reason (the drain contract — queued and
        # in-flight work is unaffected, only NEW admission closes)
        self._closed_reason: Optional[str] = None

    # ------------------------------------------------------------- draining

    def close_admission(self, reason: str = "draining") -> None:
        """Shed every subsequent submission with ``reason`` (structured,
        machine-readable — the drain/shutdown gate)."""
        with self._lock:
            self._closed_reason = str(reason)

    def open_admission(self) -> None:
        with self._lock:
            self._closed_reason = None

    def admission_closed(self) -> Optional[str]:
        with self._lock:
            return self._closed_reason

    def drain_queued(self) -> list:
        """Remove and return EVERY queued request without running it
        (quota slots released) — the journaling step of a drain; the
        caller owns the requests' terminal transition."""
        with self._cond:
            reqs = [item[2] for item in self._heap]
            self._heap = []
            for req in reqs:
                self._release_locked(req)
            self._depth_gauge()
        return reqs

    # ------------------------------------------------------------- helpers

    def _cfg(self):
        from dbcsr_tpu_torch.core.config import get_config

        return get_config()

    def _publish(self, kind: str, req: Request, **extra) -> None:
        from dbcsr_tpu_torch.obs import events as _events

        _events.publish(kind, dict(
            extra, request_id=req.request_id, tenant=req.tenant,
            op=req.op))

    def _counter(self, name: str, help: str):
        from dbcsr_tpu_torch.obs import metrics as _metrics

        return _metrics.counter(name, help)

    def _depth_gauge(self) -> None:
        from dbcsr_tpu_torch.obs import metrics as _metrics

        _metrics.gauge(
            "dbcsr_tpu_serve_queue_depth",
            "requests currently queued in the serving plane",
        ).set(float(len(self._heap)))

    def _outcome(self, req: Request, outcome: str) -> None:
        self._counter(
            "dbcsr_tpu_serve_requests_total",
            "serving-plane requests by tenant and admission/terminal "
            "outcome",
        ).inc(tenant=req.tenant, outcome=outcome)

    def _shed(self, req: Request, reason: str, detail: str) -> None:
        """The one shed path: structured rejection + bus event +
        counters + shed-storm sample, then raise."""
        self._outcome(req, "shed")
        self._counter(
            "dbcsr_tpu_serve_shed_total",
            "serving-plane submissions rejected by admission control, "
            "by tenant and reason",
        ).inc(tenant=req.tenant, reason=reason)
        self._publish("serve_shed", req, reason=reason, detail=detail)
        self._observe(shed=True)
        req._finish("shed", outcome=WEDGED, error=f"shed: {reason}"
                    + (f" ({detail})" if detail else ""))
        raise Rejected(reason, detail)

    def _observe(self, shed: bool) -> None:
        try:
            from dbcsr_tpu_torch.obs import health as _health

            _health.observe_serve(shed=shed)
        except Exception:
            pass  # health sampling must never fail admission
        try:
            # admission decisions are sample boundaries too: a shed
            # storm with no multiplies running must still land in the
            # telemetry history (cadence-gated inside)
            from dbcsr_tpu_torch.obs import timeseries as _ts

            _ts.maybe_sample()
        except Exception:
            pass

    # ------------------------------------------------------------ admission

    def admit(self, req: Request) -> str:
        """Run the admission pipeline; enqueue and return the outcome
        label (``admitted``/``queued_degraded``) or raise `Rejected`
        (request already finished as shed)."""
        if _faults.active():
            try:
                _faults.maybe_inject("serve_admit", tenant=req.tenant,
                                     request_id=req.request_id)
            except Exception as exc:
                self._shed(req, "fault",
                           f"{type(exc).__name__}: {exc}"[:200])
        closed = self.admission_closed()
        if closed is not None:
            self._shed(req, closed,
                       "admission closed: the serving plane is "
                       "draining (queued work is journaled for replay "
                       "after restart — resubmit there)")
        cfg = self._cfg()
        status = self._health_status()
        outcome = "admitted"
        if status == "CRITICAL":
            self._shed(req, "critical",
                       "health verdict CRITICAL: admission closed while "
                       "in-flight requests drain")
        if status == "DEGRADED":
            # queue, but never without a deadline: a degraded engine
            # must not accumulate unbounded patient work
            if req.t_deadline is None:
                req.t_deadline = (time.time()
                                  + cfg.serve_degraded_deadline_s)
            outcome = "queued_degraded"
        shed = None
        with self._cond:
            tenant = req.tenant
            n = self._tenant_count.get(tenant, 0)
            b = self._tenant_bytes.get(tenant, 0)
            if len(self._heap) >= cfg.serve_queue_max:
                shed = ("queue_full",
                        f"queue at capacity {cfg.serve_queue_max}")
            elif n >= cfg.serve_tenant_inflight:
                shed = ("quota_inflight",
                        f"tenant has {n} in-flight/queued requests "
                        f"(quota {cfg.serve_tenant_inflight})")
            elif b + req.nbytes > cfg.serve_tenant_bytes:
                shed = ("quota_bytes",
                        f"{b + req.nbytes} queued operand bytes over "
                        f"quota {cfg.serve_tenant_bytes}")
            else:
                req.state = "queued"
                self._tenant_count[tenant] = n + 1
                self._tenant_bytes[tenant] = b + req.nbytes
                heapq.heappush(self._heap,
                               (req.priority, next(self._seq), req))
                self._depth_gauge()
                self._cond.notify()
        if shed is not None:
            self._shed(req, *shed)
        self._outcome(req, outcome)
        self._publish("serve_admitted", req, outcome=outcome,
                      deadline_in_s=(round(req.t_deadline - time.time(), 3)
                                     if req.t_deadline else None))
        self._observe(shed=False)
        return outcome

    def _health_status(self) -> str:
        try:
            from dbcsr_tpu_torch.obs import health as _health

            return _health.admission_status()
        except Exception:
            return "OK"  # an unevaluable verdict must not close admission

    # ----------------------------------------------------------------- pop

    def _expire(self, req: Request) -> None:
        """Drop a request whose deadline passed while queued: WEDGED
        (it never ran), counted and published like a shed."""
        self._outcome(req, "deadline_missed")
        self._counter(
            "dbcsr_tpu_serve_deadline_missed_total",
            "serving-plane requests dropped at pop time because their "
            "deadline expired while queued",
        ).inc(tenant=req.tenant)
        self._publish("serve_deadline_missed", req,
                      waited_ms=round((time.time() - req.t_submit) * 1e3, 1))
        req._finish("deadline_missed", outcome=WEDGED,
                    error="deadline expired while queued")

    def pop(self, timeout: Optional[float] = None) -> Optional[Request]:
        """Next runnable request (priority order), expiring stale ones
        on the way; None when the queue stays empty past ``timeout``."""
        deadline = time.time() + timeout if timeout is not None else None
        with self._cond:
            while True:
                expired = []
                while self._heap:
                    _, _, req = heapq.heappop(self._heap)
                    if (req.t_deadline is not None
                            and time.time() > req.t_deadline):
                        self._release_locked(req)
                        expired.append(req)
                        continue
                    self._depth_gauge()
                    for e in expired:
                        self._expire(e)
                    req.t_running = time.time()
                    req.state = "running"
                    return req
                self._depth_gauge()
                for e in expired:
                    self._expire(e)
                remaining = (deadline - time.time()
                             if deadline is not None else None)
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining if remaining is not None else 0.5)

    def pop_matching(self, ckey, timeout: float) -> Optional[Request]:
        """Pop a queued request with the given coalesce key, waiting up
        to ``timeout`` for one to arrive (the batching window's gather
        step).  Expired requests encountered during the scan are
        dropped exactly like `pop`."""
        deadline = time.time() + max(0.0, timeout)
        with self._cond:
            while True:
                expired = []
                found = None
                keep = []
                for item in self._heap:
                    req = item[2]
                    if found is None and req.ckey == ckey:
                        if (req.t_deadline is not None
                                and time.time() > req.t_deadline):
                            self._release_locked(req)
                            expired.append(req)
                            continue
                        found = req
                        continue
                    keep.append(item)
                if found is not None or expired:
                    heapq.heapify(keep)
                    self._heap = keep
                    self._depth_gauge()
                for e in expired:
                    self._expire(e)
                if found is not None:
                    found.t_running = time.time()
                    found.state = "running"
                    return found
                remaining = deadline - time.time()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)

    # ------------------------------------------------------------ accounting

    def _release_locked(self, req: Request) -> None:
        # pop-at-zero: an idle tenant leaves NO residue in the quota
        # maps — a high-cardinality fleet must not leak one dict entry
        # per tenant forever (pinned by the many-tenants test)
        t = req.tenant
        n = max(0, self._tenant_count.get(t, 0) - 1)
        if n:
            self._tenant_count[t] = n
        else:
            self._tenant_count.pop(t, None)
        b = max(0, self._tenant_bytes.get(t, 0) - req.nbytes)
        if b and n:
            self._tenant_bytes[t] = b
        else:
            self._tenant_bytes.pop(t, None)

    def release(self, req: Request) -> None:
        """Return a popped request's quota slots (engine calls this
        when the request reaches a terminal state)."""
        with self._cond:
            self._release_locked(req)

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)

    def tenant_load(self) -> dict:
        with self._lock:
            return {
                t: {"requests": n,
                    "queued_bytes": self._tenant_bytes.get(t, 0)}
                for t, n in self._tenant_count.items() if n
            }
