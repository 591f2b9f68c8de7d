"""The serving-plane worker: single-writer execution over the engine.

Counterpart of `dbcsr_tpu/serve/engine.py`.  Sessions (client threads)
are producers; ONE worker thread drains the admission queue and drives
`mm.multiply`, so the engine stays single-writer and none of the
multiply machinery (plan caches, memory-pool chains, flight records)
needs to become re-entrant.

A `ServeEngine` serves one device (``device``, default the card): its
sessions' matrices live there, and the worker launches on that device's
current stream of its own thread.  A request records a CUDA event on the
submitting thread's current stream at submit, and the worker waits on
it before the request runs, so operands made on another thread or
stream are complete before a kernel reads them.

Per popped request the worker gathers the batching window: queued
requests with the same `coalesce.coalesce_key` arriving within
``serve_window_ms`` (up to ``serve_coalesce_max``) join the group and
run as one block-diagonal composite multiply.  A coalesced failure --
injected at the ``serve_execute`` fault site or real -- degrades to
serialized per-request execution on the same kernels (the group's C
matrices are untouched until the final carve, so the replay is exact),
publishing ``serve_degrade``; a serialized failure fails only its own
request (``serve_failed``, classified TRANSIENT).

Correlation: every serve event carries the ``request_id``; the multiply
opens its usual ``product_id`` scope, and the worker publishes
``serve_execute`` records binding request ids to the group.

The environment names are the port's own (``DBCSR_TPU_TORCH_SERVE_WAL``
and the like), so the two packages never read each other's settings.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

from dbcsr_tpu_torch.device import DeviceLike, resolve_device
from dbcsr_tpu_torch.obs import attribution as _attr
from dbcsr_tpu_torch.resilience import faults as _faults
from dbcsr_tpu_torch.resilience.watchdog import WEDGED
from dbcsr_tpu_torch.serve import coalesce as _coalesce
from dbcsr_tpu_torch.serve.queue import AdmissionQueue, Rejected, Request, classify
from dbcsr_tpu_torch.serve.session import Session, matrix_nbytes
from dbcsr_tpu_torch.utils import lockcheck as _lockcheck


def default_journal_path() -> str:
    """The per-process drain journal: ``DBCSR_TPU_TORCH_SERVE_JOURNAL`` when
    set (a restarted process pointing at the SAME path is what makes
    drain -> restart lossless), else a pid-suffixed file in the working
    directory."""
    return os.environ.get("DBCSR_TPU_TORCH_SERVE_JOURNAL",
                          f"serve_journal-{os.getpid()}.jsonl")


def wal_enabled() -> bool:
    """Write-ahead journaling (``DBCSR_TPU_TORCH_SERVE_WAL=1``): every
    admitted by-name request is journaled at SUBMIT time and
    tombstoned at its terminal state, so a SIGKILLed process leaves
    exactly its unfinished requests behind for a peer to replay — the
    fleet's exactly-once failover substrate (docs/serving.md § fleet).
    Off by default: single-worker drains journal at drain time only."""
    return os.environ.get("DBCSR_TPU_TORCH_SERVE_WAL", "") in ("1", "on")


def journal_ids(path: str) -> tuple:
    """``(submitted, tombstoned)`` request-id sets of a journal file —
    the fleet router's failover audit primitive (pending = submitted -
    tombstoned).  Torn tail lines are skipped like `replay_journal`."""
    sub: set = set()
    done: set = set()
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                rid = rec.get("request_id")
                if not rid:
                    continue
                (done if rec.get("replay_done") else sub).add(rid)
    except OSError:
        pass
    return sub, done


_lock = _lockcheck.wrap("serve.engine", threading.Lock())
_engine: "ServeEngine | None" = None

# request ops the engine executes; "multiply" is the only coalescable
# one — the iterative model chains run serialized inside the worker
OPS = ("multiply", "purify", "sign", "invsqrt")


class ServeEngine:
    """One serving plane on one device: admission queue, worker thread
    and statistics.  ``device`` defaults to the card; a CUDA device on a
    host without one raises."""

    def __init__(self, start: bool = True, device: Optional[DeviceLike] = None):
        self.device = resolve_device(device)
        self.queue = AdmissionQueue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._inflight = 0
        self._slock = _lockcheck.wrap("serve.engine.stats", threading.Lock())
        # finished-request lookup for /serve/status (bounded)
        self._requests: "collections.OrderedDict[str, Request]" = \
            collections.OrderedDict()
        # per-tenant rolling latencies (exact p50/p95 for /serve/tenants)
        # — bounded: idle tenants expire (`_expire_tenants_locked`), so
        # a high-cardinality fleet cannot leak one entry per tenant
        self._lat: Dict[str, collections.deque] = {}
        self._counts: Dict[str, collections.Counter] = {}
        self._tenant_seen: Dict[str, float] = {}
        self.t_start = time.time()
        self.draining = False
        # request ids already replayed from a journal (exactly-once)
        self._replayed: set = set()
        # request_id -> journal path, registered by replay_journal
        # BEFORE the resubmit so the terminal hook is attached inside
        # submit() (pre-admission) — the worker can never finish a
        # replayed request before the hook exists
        self._replay_pending: dict = {}
        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self.draining = False
        self.queue.open_admission()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dbcsr-tpu-torch-serve-worker", daemon=True)
        self._thread.start()
        # startup replay: a journal left by a drained predecessor (the
        # env-pinned path) is replayed as soon as the worker runs, so a
        # restart loses no accepted work.  Best-effort — entries whose
        # session is not (yet) registered stay journaled.
        path = os.environ.get("DBCSR_TPU_TORCH_SERVE_JOURNAL")
        if path and os.path.exists(path):
            try:
                self.replay_journal(path)
            except Exception:
                pass  # the journal survives; replay can be re-invoked
        # the online autotuner rides the serving plane's lifecycle
        # (DBCSR_TPU_TORCH_TUNE=1): its cycles defer themselves whenever
        # admission is not OK, so it can never compete with traffic.
        # Ownership is recorded: only the engine whose start() actually
        # STARTED the service stops it at shutdown — a second engine
        # (diagnostic tool, drain/restart overlap) or an explicitly
        # started embedder service must not lose its tuner to a
        # bystander's shutdown.
        self._tuner_owned = False
        try:
            from dbcsr_tpu_torch.tune import service as _tune_service

            svc = _tune_service.current_service()
            already = svc is not None and svc.running
            started = _tune_service.maybe_start_from_env()
            self._tuner_owned = started is not None and not already
        except Exception:
            pass  # a broken tuner must never block serving

    # ------------------------------------------------------ drain/restart

    def drain(self, timeout: float = 30.0,
              journal_path: Optional[str] = None) -> dict:
        """Drain the serving plane for a restart: close admission (new
        submissions shed with the structured reason ``draining``),
        journal every QUEUED request to a per-process JSONL, wait for
        in-flight work to complete, then stop the worker.  Returns
        ``{"journal": path, "journaled": n, "completed_inflight": ok}``.

        The journal line format is the idempotent resubmission record
        (request id, session id, op, by-name params) consumed by
        `replay_journal` — a restarted engine replays each accepted
        request exactly once (docs/serving.md § Drain & restart).
        Requests submitted with raw matrix OBJECTS rather than
        session-registered names cannot be journaled across a process
        boundary; they finish ``failed``/WEDGED like a non-drain
        shutdown would."""
        from dbcsr_tpu_torch.obs import events as _events
        from dbcsr_tpu_torch.obs import metrics as _metrics

        self.draining = True
        self.queue.close_admission("draining")
        path = journal_path or default_journal_path()
        _metrics.counter(
            "dbcsr_tpu_serve_drain_total",
            "serving-plane drains (admission closed, queued requests "
            "journaled, in-flight completed)",
        ).inc()
        queued = self.queue.drain_queued()
        journaled = 0
        with open(path, "a") as fh:
            for req in queued:
                if req.journal is None:
                    req._finish(
                        "failed", outcome=WEDGED,
                        error="drain: request not journalable (matrix "
                              "params passed by object, not by name)")
                    self._record(req, "failed")
                    continue
                fh.write(json.dumps(req.journal) + "\n")
                journaled += 1
                req._finish("journaled", outcome=None)
                self._record(req, "journaled")
        # complete in-flight: the worker finishes its current group
        t0 = time.time()
        while time.time() - t0 < timeout:
            with self._slock:
                if self._inflight == 0:
                    break
            time.sleep(0.01)
        with self._slock:
            drained_clean = self._inflight == 0
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        _events.publish("serve_drain", {
            "journal": path, "journaled": journaled,
            "completed_inflight": drained_clean})
        return {"journal": path, "journaled": journaled,
                "completed_inflight": drained_clean}

    def replay_journal(self, path: Optional[str] = None,
                       remove: bool = True,
                       skip_ids=()) -> List[Request]:
        """Resubmit every journaled request EXACTLY ONCE per process
        (idempotent on request id: duplicate lines, ids already
        replayed in this process, and ids whose completion tombstone is
        in the journal are all skipped).  The journal is NEVER
        rewritten at resubmit time: each replayed request appends a
        ``replay_done`` tombstone line when it reaches a terminal state
        (`_journal_mark_done`), and the file is removed only once every
        journaled submission is tombstoned — so a crash mid-replay
        re-replays the unfinished remainder on the next start
        (at-least-once across a crash, exactly-once otherwise; see
        docs/serving.md § Drain & restart).  Entries whose session id
        is not registered in this process, that admission sheds, or
        that fail to resubmit keep their lines for a later replay.

        ``skip_ids``: request ids the CALLER knows reached a terminal
        state elsewhere (the fleet router's ledger — e.g. a request
        the router re-routed after a timeout, now journaled in TWO
        workers' files).  They are tombstoned, not replayed: the fleet
        decision lands in the journal itself, so the file retires and
        a later replay of the same journal cannot double-execute.

        A journal line whose session id resolves to a session of a
        DIFFERENT tenant is skipped (line kept): on a surviving peer a
        session NAME may collide with live state, and replaying across
        that collision would hand one tenant's work — and its results
        — to another.  Returns the replayed tickets."""
        from dbcsr_tpu_torch.obs import events as _events
        from dbcsr_tpu_torch.obs import metrics as _metrics
        from dbcsr_tpu_torch.serve import session as _session

        path = path or default_journal_path()
        try:
            with open(path) as fh:
                lines = fh.readlines()
        except OSError:
            return []
        done_ids: set = set()
        recs: List[dict] = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail line (process died mid-append)
            if rec.get("replay_done"):
                done_ids.add(rec.get("request_id"))
            else:
                recs.append(rec)
        skip = {rid for rid in skip_ids if rid} - done_ids
        skip &= {r.get("request_id") for r in recs}
        if skip:
            try:
                try:
                    with open(path, "rb") as fh:
                        fh.seek(-1, os.SEEK_END)
                        torn_tail = fh.read(1) != b"\n"
                except (OSError, ValueError):
                    torn_tail = False
                with open(path, "a") as fh:
                    if torn_tail:
                        fh.write("\n")
                    for rid in sorted(skip):
                        fh.write(json.dumps(
                            {"request_id": rid, "replay_done": True,
                             "skipped": True}) + "\n")
            except OSError:
                pass  # tombstones not durable — but the caller KNOWS
                #       these ids completed elsewhere, so they must
                #       still be skipped this call (a re-execution is
                #       worse than a non-retired journal line)
            done_ids |= skip
        tickets: List[Request] = []
        for rec in recs:
            rid = rec.get("request_id")
            if not rid or rid in done_ids or rid in self._replayed:
                continue
            sess = _session.get_session(str(rec.get("session", "")))
            if sess is None:
                continue  # unresolved session: line stays journaled
            want = rec.get("tenant")
            if want is not None and sess.tenant != want:
                # session-name collision on this (surviving) process:
                # the registered session belongs to another tenant —
                # never replay across the boundary; the line stays
                # for a replay target holding the right session
                continue
            self._replay_pending[rid] = path
            try:
                req = self.submit(
                    sess, op=rec.get("op", "multiply"),
                    priority=int(rec.get("priority", 10)),
                    deadline_s=rec.get("deadline_s"),
                    request_id=rid, **(rec.get("params") or {}))
            except Exception:
                # a single bad entry must not abort the replay loop or
                # consume its journal line
                self._replay_pending.pop(rid, None)
                continue
            if req.state == "shed":
                # admission refused the replay (health CRITICAL, queue
                # or quota full): the accepted work is NOT lost — the
                # line stays journaled for the next start()/replay
                # (the terminal hook skips tombstoning shed requests)
                continue
            self._replayed.add(rid)
            tickets.append(req)
            _metrics.counter(
                "dbcsr_tpu_serve_journal_replayed_total",
                "journaled requests replayed after a drain/restart",
            ).inc(tenant=req.tenant)
            _events.publish("serve_replayed", {
                "request_id": rid, "tenant": req.tenant,
                "journal": path})
        if remove and not tickets and recs \
                and all(r.get("request_id") in done_ids for r in recs):
            # every journaled submission already has its tombstone:
            # nothing left to replay, retire the file
            try:
                os.remove(path)
            except OSError:
                pass
        return tickets

    def _journal_mark_done(self, req: Request, state: str) -> None:
        """Terminal hook of a REPLAYED request (`Request.on_terminal`,
        invoked by `_finish` for EVERY end state — done, failed,
        deadline_missed included): append the completion tombstone and
        retire the journal once every journaled submission has one.
        Ordered BEFORE the ticket turns terminal, so a missing journal
        implies the work durably completed; a crash between execution
        and tombstone re-replays the request on the next start
        (at-least-once) — accepted work is never lost.  ``shed`` and
        ``journaled`` states do NOT tombstone: the request is going
        back to (or staying in) the journal, not completing.
        EXCEPTION: a write-ahead-journaled request (`wal_enabled`)
        tombstones on shed too — its submitter (the fleet router)
        observed the structured rejection synchronously and owns the
        retry, so the line completing would otherwise replay a request
        the router already resubmitted elsewhere."""
        path = req.replay_journal_path
        if not path or state == "journaled" \
                or (state == "shed" and not req.journal_wal):
            return
        req.replay_journal_path = None
        try:
            try:
                with open(path, "rb") as fh:
                    fh.seek(-1, os.SEEK_END)
                    torn_tail = fh.read(1) != b"\n"
            except (OSError, ValueError):
                torn_tail = False  # empty or vanished file
            with open(path, "a") as fh:
                if torn_tail:
                    # the file ends mid-line (a process killed during
                    # an append): the tombstone must not merge into it
                    fh.write("\n")
                fh.write(json.dumps({"request_id": req.request_id,
                                     "replay_done": True}) + "\n")
            sub: set = set()
            done: set = set()
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    rid = rec.get("request_id")
                    if not rid:
                        continue
                    (done if rec.get("replay_done") else sub).add(rid)
            if sub <= done:
                os.remove(path)
        except OSError:
            pass

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def shutdown(self, timeout: float = 10.0, drain: bool = True) -> None:
        """Stop the worker; with ``drain`` (default) queued requests
        are executed first, otherwise they fail WEDGED."""
        if drain:
            t0 = time.time()
            while self.queue.depth() and time.time() - t0 < timeout \
                    and self.running():
                time.sleep(0.01)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        while True:
            req = self.queue.pop(timeout=0)
            if req is None:
                break
            self.queue.release(req)
            req._finish("failed", outcome=WEDGED,
                        error="serving plane shut down")
        # tuner THIS engine started (see start()): dies with the plane
        # it rode; a tuner started elsewhere is left running
        try:
            if getattr(self, "_tuner_owned", False):
                import sys

                ts_mod = sys.modules.get("dbcsr_tpu_torch.tune.service")
                if ts_mod is not None:
                    ts_mod.stop_service()
                self._tuner_owned = False
        except Exception:
            pass

    # --------------------------------------------------------------- submit

    def open_session(self, tenant: str, name: Optional[str] = None) -> Session:
        return Session(tenant, name=name, device=self.device)

    def submit(self, session: Session, op: str = "multiply",
               priority: int = 10, deadline_s: Optional[float] = None,
               request_id: Optional[str] = None,
               **params) -> Request:
        """Submit one request.  Matrix params (``a``/``b``/``c``) may
        be `BlockSparseMatrix` objects or names registered in the
        session.  Returns the `Request` ticket — on admission
        rejection the ticket comes back already terminal
        (``state == "shed"``) instead of raising, so many-client
        drivers handle shedding uniformly.  Malformed submissions
        (unknown ``op`` -> ValueError, unregistered matrix name ->
        KeyError) raise before a ticket exists — client errors, not
        admission decisions (the HTTP route maps them to 400/404)."""
        if op not in OPS:
            raise ValueError(f"unknown serve op {op!r} (one of {OPS})")
        if session.device != self.device:
            raise ValueError(f"session {session.session_id!r} lives on {session.device}, "
                             f"the engine on {self.device}")
        params = dict(params)
        # drain-journal record: resubmittable iff every matrix param
        # came by session-registered NAME (the serving surface's normal
        # shape — raw objects cannot cross a process boundary)
        # ...and every NON-matrix param must be JSON-native, or the
        # replay would silently run with defaults (np.float32 alpha,
        # np.bool_ retain_sparsity are NOT float/bool subclasses) —
        # such a request fails WEDGED at drain instead of replaying
        # wrong
        journalable = all(
            isinstance(params[k], str)
            for k in ("a", "b", "c", "p") if k in params
        ) and all(
            isinstance(v, (str, int, float, bool)) or v is None
            for k, v in params.items() if k not in ("a", "b", "c", "p")
        )
        journal_params = dict(params) if journalable else None
        for key in ("a", "b", "c", "p"):
            if isinstance(params.get(key), str):
                params[key] = session.get(params[key])
        req = Request(session, op, params, priority=priority,
                      deadline_s=deadline_s, request_id=request_id)
        if self._replay_pending:
            rj = self._replay_pending.pop(req.request_id, None)
            if rj is not None:
                # journal-replayed resubmission: attach the tombstone
                # hook BEFORE admission, so no terminal transition —
                # however fast the worker — can precede it
                req.replay_journal_path = rj
                req.on_terminal = self._journal_mark_done
        if journal_params is not None:
            req.journal = {
                "request_id": req.request_id,
                "session": session.session_id,
                "tenant": req.tenant,
                "op": op,
                "priority": req.priority,
                "deadline_s": deadline_s,
                "params": journal_params,
            }
            if req.on_terminal is None and wal_enabled():
                # write-ahead journal (fleet workers): the line lands
                # BEFORE admission and the tombstone hook attaches with
                # it, so a SIGKILL at ANY later point leaves exactly
                # the unfinished requests pending in the journal
                wal_path = default_journal_path()
                try:
                    with open(wal_path, "a") as fh:
                        fh.write(json.dumps(req.journal) + "\n")
                except OSError:
                    pass  # an unwritable WAL must not refuse traffic
                else:
                    req.journal_wal = True
                    req.replay_journal_path = wal_path
                    req.on_terminal = self._journal_mark_done
        req.nbytes = self._operand_bytes(params)
        req.ckey = _coalesce.coalesce_key(op, params)
        if self.device.type == "cuda":
            # the operands are complete on the submitting thread's
            # stream; the worker waits for this before the request runs
            req.ready = torch.cuda.Event()
            req.ready.record(torch.cuda.current_stream(self.device))
        _attr.on_submit(req)
        from dbcsr_tpu_torch.obs import events as _events

        _events.publish("serve_submitted", {
            "request_id": req.request_id, "tenant": req.tenant,
            "op": op, "priority": req.priority,
            "coalescable": req.ckey is not None})
        self._remember(req)
        try:
            self.queue.admit(req)
        except Rejected:
            pass  # the ticket carries the structured rejection
        return req

    def _operand_bytes(self, params: dict) -> int:
        return sum(matrix_nbytes(params[k]) for k in ("a", "b", "c", "p")
                   if hasattr(params.get(k), "bins"))

    def _remember(self, req: Request) -> None:
        with self._slock:
            self._requests[req.request_id] = req
            while len(self._requests) > 1024:
                self._requests.popitem(last=False)

    def get_request(self, request_id: str) -> Optional[Request]:
        with self._slock:
            return self._requests.get(request_id)

    # ---------------------------------------------------------------- worker

    def _run(self) -> None:
        from dbcsr_tpu_torch.core.config import get_config

        while not self._stop.is_set():
            req = self.queue.pop(timeout=0.1)
            if req is None:
                continue
            cfg = get_config()
            group = [req]
            if (cfg.serve_coalesce and req.ckey is not None
                    and cfg.serve_coalesce_max > 1):
                deadline = time.time() + cfg.serve_window_ms / 1e3
                while len(group) < cfg.serve_coalesce_max:
                    nxt = self.queue.pop_matching(
                        req.ckey, timeout=deadline - time.time())
                    if nxt is None:
                        break
                    group.append(nxt)
            with self._slock:
                self._inflight += len(group)
            try:
                if self.device.type == "cuda":
                    stream = torch.cuda.current_stream(self.device)
                    for r in group:
                        if r.ready is not None:
                            stream.wait_event(r.ready)
                    with torch.cuda.device(self.device):
                        self._execute_group(group)
                else:
                    self._execute_group(group)
            finally:
                with self._slock:
                    self._inflight -= len(group)
                for r in group:
                    self.queue.release(r)

    def _execute_group(self, group: List[Request]) -> None:
        from dbcsr_tpu_torch.acc import abft as _abft
        from dbcsr_tpu_torch.obs import events as _events
        from dbcsr_tpu_torch.obs import metrics as _metrics

        ids = [r.request_id for r in group]
        # attribution: close the pre-execution phases — queued is the
        # submit -> pop edge, coalesce-wait the pop -> execute edge
        # (the batching-window gather every popped request sat through)
        t_exec = time.time()
        for r in group:
            if r.t_running is not None:
                _attr.phase(r.request_id, "queued",
                            r.t_running - r.t_submit)
                _attr.phase(r.request_id, "coalesce_wait",
                            t_exec - r.t_running)
        # under ABFT every request runs serialized: the per-request
        # probe + pre-execution snapshot (the recover path's rollback
        # scope) is per-C, which the composite's carve-last contract
        # cannot provide mid-launch
        coalesced = (len(group) > 1 and not _abft.enabled()
                     and self._group_coalescable(group))
        degraded = False
        _events.publish("serve_execute", {
            "request_ids": ",".join(ids), "n": len(group),
            "tenants": ",".join(sorted({r.tenant for r in group})),
            "mode": "coalesced" if coalesced else "serialized"})
        if _faults.active():
            try:
                _faults.maybe_inject("serve_execute",
                                     request_id=ids[0], n=str(len(group)))
            except Exception as exc:
                # group-level fault: with a group this is the coalesced
                # launch failing -> degrade to serialized below; a lone
                # request fails TRANSIENT like any execution error
                if coalesced:
                    self._degrade(group, exc)
                    coalesced = False
                    degraded = True
                else:
                    self._fail(group[0], exc)
                    if len(group) == 1:
                        return
                    # the rest of a serialized group still runs — a
                    # request must never be left non-terminal
        if coalesced:
            # one billing window brackets the composite launch: on
            # success the measured cost splits by the per-request true-
            # flop shares; on failure the shares never materialized, so
            # the (partial) cost splits equally — either way the window
            # is billed exactly once, so a degrade replay's serialized
            # windows can never double-bill the composite's
            tok = _attr.begin_window()
            try:
                flops = _coalesce.execute_coalesced(group)
            except _coalesce.Unrecoverable as exc:
                # the carve already wrote some target Cs and beta != 0:
                # a serialized replay would re-apply beta to a C that
                # is no longer the submitted one — fail, never corrupt
                _attr.bill_window(tok, group)
                for r in group:
                    self._fail(r, exc)
                return
            except Exception as exc:
                # the composite never touched the per-request Cs (the
                # carve is the last step, and a partial carve raises
                # Unrecoverable above), so the serialized replay is
                # exact — mid-request failover, not request death
                _attr.bill_window(tok, group)
                self._degrade(group, exc)
                degraded = True
            else:
                _attr.bill_window(tok, group,
                                  weights=[int(f) for f in flops])
                _metrics.counter(
                    "dbcsr_tpu_serve_coalesced_total",
                    "request groups executed as one block-diagonal "
                    "composite multiply, by group size",
                ).inc(group_size=str(len(group)))
                for r, f in zip(group, flops):
                    self._finish_ok(r, {"flops": int(f),
                                        "coalesced": len(group)})
                return
        # a degrade replay's serialized windows land in the "serialize"
        # phase; first-try serialized execution is the "execute" phase
        pname = "serialize" if degraded else "execute"
        for r in group:
            if r.done:
                continue  # already failed by a group-level fault
            tok = _attr.begin_window()
            try:
                result = self._execute_one(r)
            except Exception as exc:
                _attr.bill_window(tok, [r], phase_name=pname)
                self._fail(r, exc)
            else:
                _attr.bill_window(tok, [r], phase_name=pname)
                if result.get("cached"):
                    _attr.credit_saved(r, result.get("saved_flops", 0),
                                       result.get("saved_seconds", 0.0))
                self._finish_ok(r, result)

    def _group_coalescable(self, group: List[Request]) -> bool:
        """A group is only safe to assemble when no request's C object
        appears anywhere else in the group — as another request's C
        (two products racing into one destination) or as any A/B
        operand (a later request reading a C the composite is about to
        overwrite would see the pre-multiply values).  Serialized
        execution in submit order is the reference semantics."""
        cs = [id(r.params.get("c")) for r in group]
        if len(set(cs)) < len(group):
            return False
        c_ids = set(cs)
        for r in group:
            for key in ("a", "b"):
                if id(r.params.get(key)) in c_ids:
                    return False
        return True

    def _degrade(self, group: List[Request], exc: Exception) -> None:
        from dbcsr_tpu_torch.obs import events as _events
        from dbcsr_tpu_torch.obs import metrics as _metrics

        _metrics.counter(
            "dbcsr_tpu_serve_degrade_total",
            "coalesced groups that failed and were re-executed "
            "serialized (mid-request failover)",
        ).inc()
        _events.publish("serve_degrade", {
            "request_ids": ",".join(r.request_id for r in group),
            "n": len(group), "reason": "coalesce_failover",
            "error": f"{type(exc).__name__}: {exc}"[:200]})

    def _execute_one(self, req: Request) -> dict:
        from dbcsr_tpu_torch.core import mempool

        p = req.params
        if req.op == "multiply":
            return self._execute_multiply(req)
        # iterative model chains: the per-step temporaries recycle
        # through the models' own mempool chains; the result lands in
        # the session under params["out"]
        steps = int(p.get("steps", 1))
        src = p["a"] if "a" in p else p["p"]
        filter_eps = p.get("filter_eps")
        if req.op == "purify":
            from dbcsr_tpu_torch.models.purify import mcweeny_step

            with mempool.chain() as ch:
                cur = src
                for _ in range(steps):
                    nxt = mcweeny_step(cur, filter_eps=filter_eps)
                    if cur is not src:
                        ch.retire(cur)
                    cur = nxt
                ch.detach(cur)
            out, extra = cur, {"steps": steps}
        elif req.op == "sign":
            from dbcsr_tpu_torch.models.sign import sign_iteration

            out, hist = sign_iteration(src, steps=steps,
                                       filter_eps=filter_eps)
            extra = {"steps": len(hist)}
        else:  # invsqrt
            from dbcsr_tpu_torch.models.invsqrt import invsqrt_iteration

            out, sf, iters = invsqrt_iteration(src, max_iter=steps,
                                               filter_eps=filter_eps)
            extra = {"iterations": iters, "scale_factor": sf}
        out_name = p.get("out", f"{req.op}_out")
        req.session.put(out_name, out)
        return dict(extra, out=out_name, coalesced=0)

    def _execute_multiply(self, req: Request) -> dict:
        """One serialized multiply request, probe-verified when the
        ABFT knob is on and the request admits the algebraic identity
        (`acc.abft.product_probeable`): ``C_new·v`` must equal
        ``alpha*A@(B@v) + beta*(C_old·v)``.  On a mismatch the
        pre-execution checkpoint of C restores and the request
        re-executes ONCE (the transient-SDC model), re-verified before
        the result is accepted — a second mismatch fails the request
        with the structured ABFT error (docs/serving.md § Integrity)."""
        from dbcsr_tpu_torch.acc import abft as _abft
        from dbcsr_tpu_torch.core import mempool
        from dbcsr_tpu_torch.mm.multiply import multiply
        from dbcsr_tpu_torch.serve import product_cache as _pcache

        p = req.params
        # content-addressed product cache: an identical (A, B, alpha,
        # flags, C-pattern) submission — keyed by VALUE digests,
        # invalidated through the mutation-epoch machinery — returns
        # the cached C with zero engine dispatches.  Every cacheable
        # product is probeable, so with the ABFT knob on the hit is
        # re-certified against the live operands before it is served;
        # a condemned entry is dropped and the request dispatches.
        pckey = _pcache.key_of(p) if _pcache.enabled() else None
        if pckey is not None:
            ent = _pcache.lookup(pckey, tenant=req.tenant)
            if ent is None:
                # fleet tier: a digest hit on ANY sibling worker
                # serves this request (DBCSR_TPU_TORCH_FLEET_PEERS; bounded
                # degradation to local-only on slow/down peers)
                ent = _pcache.peer_lookup(pckey, tenant=req.tenant, device=self.device)
            if ent is not None:
                _pcache.install(ent, p["c"])
                self._maybe_corrupt_result(p["c"], req.request_id)
                served = True
                if _abft.enabled():
                    try:
                        _abft.verify_product(
                            p["a"], p["b"], p["c"], p.get("alpha", 1.0),
                            0.0, None, request_id=req.request_id)
                    except _abft.AbftMismatchError:
                        # stale or corrupted entry: never serve it —
                        # drop and fall through to a real dispatch
                        _pcache.invalidate(pckey, tenant=req.tenant)
                        served = False
                if served:
                    _pcache.note_served(ent, tenant=req.tenant)
                    return {"flops": 0, "coalesced": 0, "cached": 1,
                            "saved_flops": ent.flops,
                            "saved_seconds": ent.seconds}
        args = (p.get("transa", "N"), p.get("transb", "N"),
                p.get("alpha", 1.0), p["a"], p["b"],
                p.get("beta", 0.0), p["c"])
        kw = dict(retain_sparsity=bool(p.get("retain_sparsity", False)),
                  filter_eps=p.get("filter_eps"))
        abft_on = _abft.enabled() and _abft.product_probeable(p)
        if not abft_on:
            t0 = time.perf_counter()
            flops = multiply(*args, **kw)
            if pckey is not None:
                # banked BEFORE the fault hook: an injected
                # serve_execute corruption is per-request and must
                # never outlive its window through the cache (the
                # ABFT path gets the same guarantee from certifying
                # before it stores)
                _pcache.store(pckey, p["c"], req.tenant, flops,
                              seconds=time.perf_counter() - t0)
            self._maybe_corrupt_result(p["c"], req.request_id)
            return {"flops": int(flops), "coalesced": 0}
        a, b, c = p["a"], p["b"], p["c"]
        alpha, beta = p.get("alpha", 1.0), p.get("beta", 0.0)
        snap = mempool.snapshot_matrix(c)
        r_old = None
        if beta:
            r_old = _abft.matrix_probe(
                c, _abft.probe_vector(c.nfullcols, c.dtype, device=c.device))
        t0 = time.perf_counter()
        flops = multiply(*args, **kw)
        self._maybe_corrupt_result(c, req.request_id)
        try:
            _abft.verify_product(a, b, c, alpha, beta, r_old,
                                 request_id=req.request_id)
        except _abft.AbftMismatchError:
            # roll C back to the accepted pre-request state and
            # re-execute; the re-run is verified before acceptance
            # (``recover`` semantics — at the serve boundary a merely
            # detected-but-unrecovered wrong answer must never reach
            # the tenant, so verify implies one recovery attempt)
            mempool.restore_matrix(snap)
            flops = multiply(*args, **kw)
            self._maybe_corrupt_result(c, req.request_id)
            try:
                _abft.verify_product(a, b, c, alpha, beta, r_old,
                                     request_id=req.request_id)
            except _abft.AbftMismatchError:
                # the re-run is ALSO condemned: fail the request, but
                # first put the session's C back to its accepted
                # pre-request state — a failed request must not leave
                # silently-corrupted data registered for later reads
                mempool.restore_matrix(snap)
                raise
            _abft.record_recovery("serve")
        if pckey is not None:
            # banked only AFTER the probe certified the result: the
            # cache can never hold a C the ABFT plane has not accepted
            _pcache.store(pckey, c, req.tenant, flops,
                          seconds=time.perf_counter() - t0)
        return {"flops": int(flops), "coalesced": 0, "verified": 1}

    def _maybe_corrupt_result(self, c, request_id: str) -> None:
        """Fault hook: a configured ``serve_execute:nan``/``flip`` spec
        corrupts the request's freshly computed C (the simulated
        served-silent-corruption) — what the per-request probe exists
        to catch."""
        if not _faults.active():
            return
        c.map_bin_data(
            lambda d: _faults.corrupt("serve_execute", d,
                                      request_id=request_id))

    # ---------------------------------------------------------- accounting

    def _finish_ok(self, req: Request, result: dict) -> None:
        from dbcsr_tpu_torch.obs import events as _events

        req.error = None
        outcome = classify(req)
        req._finish("done", outcome=outcome, result=result)
        self._record(req, "done")
        _events.publish("serve_done", {
            "request_id": req.request_id, "tenant": req.tenant,
            "outcome": outcome,
            "latency_ms": req.info()["latency_ms"],
            "coalesced": result.get("coalesced", 0)})

    def _fail(self, req: Request, exc: Exception) -> None:
        from dbcsr_tpu_torch.obs import events as _events

        err = f"{type(exc).__name__}: {exc}"[:300]
        req.error = err
        req._finish("failed", outcome=classify(req), error=err)
        self._record(req, "failed")
        _events.publish("serve_failed", {
            "request_id": req.request_id, "tenant": req.tenant,
            "error": err})

    def _record(self, req: Request, outcome: str) -> None:
        from dbcsr_tpu_torch.obs import metrics as _metrics

        lat_ms = (req.t_done - req.t_submit) * 1e3
        now = time.time()
        with self._slock:
            self._lat.setdefault(
                req.tenant, collections.deque(maxlen=512)).append(lat_ms)
            self._counts.setdefault(
                req.tenant, collections.Counter())[outcome] += 1
            self._tenant_seen[req.tenant] = now
            self._expire_tenants_locked(now)
        _metrics.counter(
            "dbcsr_tpu_serve_requests_total",
            "serving-plane requests by tenant and admission/terminal "
            "outcome",
        ).inc(tenant=req.tenant, outcome=outcome)
        _metrics.histogram(
            "dbcsr_tpu_serve_latency_ms",
            "request latency (submit to terminal state) per tenant",
            buckets=(1, 5, 10, 50, 100, 500, 1000, 5000, 30000),
        ).observe(lat_ms, tenant=req.tenant)

    def _expire_tenants_locked(self, now: float) -> None:
        """Bound the per-tenant accounting maps (`_slock` held): drop
        tenants idle past ``DBCSR_TPU_TORCH_SERVE_TENANT_TTL_S`` and, past
        ``DBCSR_TPU_TORCH_SERVE_TENANT_MAX`` rows, the least recently active
        — a high-cardinality fleet must not grow these dicts forever.
        Expiry loses only the rolling latency window and local outcome
        tally; the metrics-registry counters (and the attribution
        ledger's own bounded rollup) remain the durable record."""
        try:
            ttl = float(os.environ.get("DBCSR_TPU_TORCH_SERVE_TENANT_TTL_S",
                                       "3600"))
        except ValueError:
            ttl = 3600.0
        try:
            cap = max(4, int(os.environ.get("DBCSR_TPU_TORCH_SERVE_TENANT_MAX",
                                            "256")))
        except ValueError:
            cap = 256
        for t, seen in list(self._tenant_seen.items()):
            if now - seen > ttl:
                self._drop_tenant_locked(t)
        while len(self._tenant_seen) > cap:
            oldest = min(self._tenant_seen, key=self._tenant_seen.get)
            self._drop_tenant_locked(oldest)

    def _drop_tenant_locked(self, tenant: str) -> None:
        self._tenant_seen.pop(tenant, None)
        self._lat.pop(tenant, None)
        self._counts.pop(tenant, None)

    # -------------------------------------------------------------- surface

    def status(self) -> dict:
        from dbcsr_tpu_torch.core.config import get_config
        from dbcsr_tpu_torch.serve import session as _session

        cfg = get_config()
        with self._slock:
            inflight = self._inflight
        return {
            "running": self.running(),
            "draining": self.draining,
            "admission_closed": self.queue.admission_closed(),
            "queue_depth": self.queue.depth(),
            "inflight": inflight,
            "sessions": len(_session.sessions()),
            "uptime_s": round(time.time() - self.t_start, 3),
            "coalesce": {
                "enabled": bool(cfg.serve_coalesce),
                "window_ms": cfg.serve_window_ms,
                "max_group": cfg.serve_coalesce_max,
            },
            "quotas": {
                "queue_max": cfg.serve_queue_max,
                "tenant_inflight": cfg.serve_tenant_inflight,
                "tenant_bytes": cfg.serve_tenant_bytes,
            },
        }

    def tenants(self) -> dict:
        """Per-tenant serving metrics: admission/terminal counters off
        the metrics registry (shared with /metrics scrapes), queue
        load, and exact rolling p50/p95 latency."""
        from dbcsr_tpu_torch.obs import metrics as _metrics

        out: dict = {}
        for lab, v in _metrics.counter_items(
                "dbcsr_tpu_serve_requests_total"):
            t = lab.get("tenant", "?")
            out.setdefault(t, {})[lab.get("outcome", "?")] = int(v)
        for lab, v in _metrics.counter_items("dbcsr_tpu_serve_shed_total"):
            ent = out.setdefault(lab.get("tenant", "?"), {})
            ent.setdefault("shed_by_reason", {})[
                lab.get("reason", "?")] = int(v)
        for lab, v in _metrics.counter_items(
                "dbcsr_tpu_serve_deadline_missed_total"):
            out.setdefault(lab.get("tenant", "?"), {})[
                "deadline_missed"] = int(v)
        load = self.queue.tenant_load()
        lats = self.latency_quantiles()
        for t, ent in out.items():
            ent.update(load.get(t, {}))
            if t in lats:
                ent.update(lats[t])
        return out

    def latency_quantiles(self) -> dict:
        """{tenant: {"p50_ms", "p95_ms"}} over the rolling latency
        windows — the exact empirical quantiles (`obs.windows.p50_p95`,
        the shared convention `/serve/tenants` has always reported and
        the telemetry time-series store samples)."""
        from dbcsr_tpu_torch.obs import windows as _windows

        with self._slock:
            snap = {t: list(d) for t, d in self._lat.items() if d}
        out = {}
        for t, xs in snap.items():
            p50, p95 = _windows.p50_p95(xs)
            out[t] = {"p50_ms": round(p50, 3), "p95_ms": round(p95, 3)}
        return out


# ----------------------------------------------------------- module API

def get_engine(start: bool = True, device: Optional[DeviceLike] = None) -> ServeEngine:
    """The process's default serving plane (created on first use, on
    ``device``, default the card)."""
    global _engine
    with _lock:
        if _engine is None:
            _engine = ServeEngine(start=start, device=device)
        elif start and not _engine.running():
            _engine.start()
        return _engine


def current_engine() -> Optional[ServeEngine]:
    return _engine


def shutdown(timeout: float = 10.0) -> None:
    global _engine
    with _lock:
        eng = _engine
        _engine = None
    if eng is not None:
        eng.shutdown(timeout=timeout)
