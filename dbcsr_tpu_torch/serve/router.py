"""Health-aware fleet router: placement, failure detection, failover.

Counterpart of `dbcsr_tpu/serve/router.py`.  The robustness layer that binds N serve workers (own OS process, own
engine, own obs endpoint on the port-offset scheme — `serve.fleet`
spawns them) into ONE serving plane:

* **Placement** — sessions stick to a worker by tenant affinity; a new
  tenant lands on the routable worker carrying the fewest tenants.  A
  worker is routable while its heartbeat answers, it is not draining,
  and its ``/healthz`` is not CRITICAL (503 ⇒ unroutable — the
  load-balancer convention the endpoint has always spoken).

* **Failure detection** — `check()` runs one heartbeat round
  (``/serve/heartbeat``) over the table: a missed beat moves UP →
  SUSPECT, ``DBCSR_TPU_TORCH_FLEET_SUSPECT_AFTER`` consecutive misses move
  SUSPECT → DOWN (rising-edge ``worker_down`` bus event + the
  ``dbcsr_tpu_fleet_worker_up{worker}`` gauge), and a beat answering
  again rejoins the worker UP.  The liveness map feeds the advisory
  ``fleet`` health component (`obs.health.observe_fleet`).  A DOWN
  worker is skipped at placement and submit without being probed —
  a dead peer costs ONE timeout, not one per request.

* **Routed submit** — env-tunable timeout/retry/backoff
  (``DBCSR_TPU_TORCH_FLEET_SUBMIT_TIMEOUT_S`` / ``_RETRIES`` /
  ``_BACKOFF_S``).  A timed-out attempt is AMBIGUOUS (the worker may
  have admitted it), so before re-sending the router probes
  ``/serve/status?request_id=`` — a known request is polled, never
  resubmitted: the router half of the exactly-once contract (the
  worker half is the write-ahead journal, `engine.wal_enabled`).

* **Exactly-once failover** — `failover(dead)` re-pins the dead
  worker's sessions on a surviving peer under the SAME session ids
  (re-creating their recorded matrices/staged entries from
  deterministic specs), then replays the dead worker's journal there
  with ``skip_ids`` = the ledger's already-completed ids, so a request
  journaled by TWO workers (routed, timed out, re-routed) lands
  exactly once fleet-wide.  The replay ledger (`audit()`) is the
  proof: every admitted id, exactly one ``done`` landing.

Fault sites ``fleet_route`` (placement/submit), ``worker_heartbeat``
(probe) and ``fleet_handoff`` (failover) fire here, driven by the
fleet tests (a multi-process topology: out of the one-process
randomized draw).

Stdlib HTTP (urllib) only, and no torch at import: the router must
route around a worker whose card just wedged, so it depends on none of
its stack.  A worker that could not start on its device never answers
a heartbeat, so the router reports it down.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Dict, List, Optional

from dbcsr_tpu_torch.resilience import faults as _faults
from dbcsr_tpu_torch.serve.queue import DONE_STATES

# fleet-wide "settled": the request produced (or conclusively failed
# to produce) a result SOMEWHERE.  ``journaled`` is terminal for the
# worker that drained it but is a hand-off, not a resolution — the
# replay on the peer supplies the settled landing.
SETTLED_STATES = tuple(s for s in DONE_STATES if s != "journaled")

UP, SUSPECT, DOWN = "up", "suspect", "down"

_LEDGER_MAX = 65536


class RouteError(RuntimeError):
    """A request the router could not land on any worker (every
    attempt failed or no routable worker exists).  The submission is
    NOT lost when the target journals write-ahead — failover replays
    it; the caller may also simply retry."""


def _envf(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _envi(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class Worker:
    """One fleet member as the router sees it."""

    __slots__ = ("name", "url", "journal", "state", "misses",
                 "draining", "last_beat")

    def __init__(self, name: str, url: str,
                 journal: Optional[str] = None):
        self.name = str(name)
        self.url = str(url).rstrip("/")
        self.journal = journal  # its DBCSR_TPU_TORCH_SERVE_JOURNAL path
        self.state = UP
        self.misses = 0
        self.draining = False
        self.last_beat: Optional[float] = None

    def routable(self) -> bool:
        return self.state != DOWN and not self.draining

    def snapshot(self) -> dict:
        return {"name": self.name, "url": self.url,
                "journal": self.journal, "state": self.state,
                "misses": self.misses, "draining": self.draining,
                "last_beat": self.last_beat}


class FleetRouter:
    """The routing table + ledger over a set of workers (see module
    docstring).  ``workers``: ``[(name, url)]`` or ``[(name, url,
    journal_path)]`` (the journal path enables failover replay)."""

    def __init__(self, workers):
        self.workers: "collections.OrderedDict[str, Worker]" = \
            collections.OrderedDict()
        for row in workers:
            w = Worker(*row) if not isinstance(row, Worker) else row
            self.workers[w.name] = w
        self.affinity: Dict[str, str] = {}          # tenant -> worker
        # session_id -> binding: tenant, worker, recorded matrix specs
        # and staged entries (the deterministic re-pin material)
        self.sessions: Dict[str, dict] = {}
        # request_id -> {"tenant", "landings": {worker: last state}}
        # — the fleet-wide exactly-once evidence `audit()` checks
        self.ledger: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    # ------------------------------------------------------------- http

    def _call(self, url: str, route: str, body: Optional[dict],
              timeout: float) -> dict:
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            url + route, data=data,
            headers={"Content-Type": "application/json"} if data
            else {})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode() or "{}")

    # ---------------------------------------------------------- metrics

    def _metric(self, outcome: str, worker: str) -> None:
        from dbcsr_tpu_torch.obs import metrics as _metrics

        _metrics.counter(
            "dbcsr_tpu_fleet_requests_total",
            "fleet-routed submissions by worker and routing outcome "
            "(routed/retried/failed)",
        ).inc(worker=worker, outcome=outcome)

    def observe(self) -> None:
        """Publish the liveness map: the per-worker up gauge + the
        advisory ``fleet`` health component."""
        from dbcsr_tpu_torch.obs import health as _health
        from dbcsr_tpu_torch.obs import metrics as _metrics

        g = _metrics.gauge(
            "dbcsr_tpu_fleet_worker_up",
            "fleet worker liveness as the router sees it (1 = "
            "routable heartbeat, 0 = suspected/declared down)")
        snap = {}
        for w in self.workers.values():
            up = w.state == UP
            g.set(1.0 if up else 0.0, worker=w.name)
            snap[w.name] = up
        _health.observe_fleet(snap)

    # ------------------------------------------------- failure detection

    def check(self) -> Dict[str, str]:
        """One heartbeat round over the whole table; returns
        ``{worker: state}`` after the round.  DOWN workers ARE probed
        here (heartbeat is how they rejoin) — but only once per round,
        never per request."""
        timeout = _envf("DBCSR_TPU_TORCH_FLEET_HEARTBEAT_TIMEOUT_S", 2.0)
        for w in self.workers.values():
            try:
                if _faults.active():
                    _faults.maybe_inject("worker_heartbeat",
                                         worker=w.name)
                beat = self._call(w.url, "/serve/heartbeat", None,
                                  timeout)
            except Exception:
                self._note_miss(w)
                continue
            w.misses = 0
            w.last_beat = time.time()
            w.draining = bool(beat.get("draining"))
            if w.state != UP:
                w.state = UP
                self._publish("worker_up", {"worker": w.name})
        self.observe()
        return {w.name: w.state for w in self.workers.values()}

    def _note_miss(self, w: Worker) -> None:
        w.misses += 1
        if w.state == DOWN:
            return
        after = max(1, _envi("DBCSR_TPU_TORCH_FLEET_SUSPECT_AFTER", 3))
        if w.misses >= after:
            self._declare_down(w)
        elif w.state == UP:
            w.state = SUSPECT

    def _declare_down(self, w: Worker) -> None:
        if w.state == DOWN:
            return
        w.state = DOWN
        from dbcsr_tpu_torch.obs import metrics as _metrics

        _metrics.counter(
            "dbcsr_tpu_fleet_worker_down_total",
            "fleet workers declared DOWN by the router's suspicion "
            "ladder (missed heartbeats past the threshold)",
        ).inc(worker=w.name)
        self._publish("worker_down", {
            "worker": w.name, "misses": w.misses,
            "hint": "a worker missed its heartbeats; failover() moves its sessions"})

    def mark_down(self, name: str) -> None:
        """Out-of-band death knowledge (the fleet supervisor saw the
        process exit): skip the suspicion ladder."""
        self._declare_down(self.workers[name])
        self.observe()

    def rejoin(self, name: str) -> None:
        """A respawned/recovered worker rejoins the routable set."""
        w = self.workers[name]
        w.state, w.misses, w.draining = UP, 0, False
        self.observe()

    def _publish(self, kind: str, payload: dict) -> None:
        try:
            from dbcsr_tpu_torch.obs import events as _events

            _events.publish(kind, payload)
        except Exception:
            pass

    # ---------------------------------------------------------- placement

    def place(self, tenant: str) -> Worker:
        """The worker serving ``tenant``: sticky affinity while the
        bound worker stays routable, else the routable worker carrying
        the fewest tenants (probed via ``/healthz`` — 503/CRITICAL ⇒
        unroutable, the load-balancer convention)."""
        bound = self.affinity.get(tenant)
        if bound is not None:
            w = self.workers.get(bound)
            if w is not None and w.routable():
                return w
        loads: Dict[str, int] = {n: 0 for n in self.workers}
        for t, n in self.affinity.items():
            if n in loads:
                loads[n] += 1
        timeout = _envf("DBCSR_TPU_TORCH_FLEET_HEARTBEAT_TIMEOUT_S", 2.0)
        for w in sorted(self.workers.values(),
                        key=lambda w: (loads.get(w.name, 0), w.name)):
            if not w.routable():
                continue  # DOWN costs nothing per request
            try:
                v = self._call(w.url, "/healthz", None, timeout)
            except urllib.error.HTTPError as exc:
                if exc.code == 503:
                    continue  # CRITICAL: alive but unroutable
                self._note_miss(w)
                continue
            except Exception:
                self._note_miss(w)
                continue
            if v.get("status") == "CRITICAL":
                continue
            self.affinity[tenant] = w.name
            return w
        raise RouteError(f"no routable worker for tenant {tenant!r} "
                         f"({ {n: w.state for n, w in self.workers.items()} })")

    # ----------------------------------------------------------- sessions

    def open_session(self, tenant: str,
                     session_id: Optional[str] = None) -> str:
        """Open a session on the tenant's placed worker; returns the
        session id.  The binding (worker + every matrix/stage spec
        that follows) is recorded — failover re-pins it elsewhere."""
        w = self.place(tenant)
        resp = self._call(
            w.url, "/serve/session/open",
            {"tenant": tenant, "session_id": session_id},
            _envf("DBCSR_TPU_TORCH_FLEET_SUBMIT_TIMEOUT_S", 10.0))
        sid = resp["session_id"]
        with self._lock:
            self.sessions.setdefault(sid, {
                "tenant": tenant, "worker": w.name,
                "matrices": [], "entries": []})["worker"] = w.name
        return sid

    def matrix(self, session_id: str, **spec) -> dict:
        """Create a matrix in the session by deterministic spec (the
        ``/serve/matrix`` shape: name/row_blk/col_blk/dtype/occupation/
        seed or kind="create"); the spec is recorded for re-pinning."""
        b = self.sessions[session_id]
        w = self.workers[b["worker"]]
        resp = self._call(w.url, "/serve/matrix",
                          dict(spec, session=session_id),
                          _envf("DBCSR_TPU_TORCH_FLEET_SUBMIT_TIMEOUT_S", 10.0))
        with self._lock:
            b["matrices"].append(dict(spec))
        return resp

    def stage(self, session_id: str, entry: dict) -> dict:
        """Stage one workload stream entry on the session's worker
        (returns the submit kwargs); the entry is recorded for
        re-pinning."""
        b = self.sessions[session_id]
        w = self.workers[b["worker"]]
        resp = self._call(w.url, "/serve/stage",
                          {"session": session_id, "entry": entry},
                          _envf("DBCSR_TPU_TORCH_FLEET_SUBMIT_TIMEOUT_S", 10.0))
        with self._lock:
            b["entries"].append(dict(entry))
        return resp["kwargs"]

    # ------------------------------------------------------------- submit

    def submit(self, session_id: str, request_id: Optional[str] = None,
               wait: bool = False, timeout_s: float = 30.0,
               **body) -> dict:
        """Route one request to the session's worker with env-tunable
        timeout/retry/backoff.  Returns the request info payload; a
        shed comes back as ``state == "shed"`` (the caller owns that
        retry — shedding is an admission decision, not a routing
        failure).  Raises `RouteError` when every attempt failed."""
        b = self.sessions[session_id]
        w = self.workers[b["worker"]]
        rid = request_id or f"fleet-{uuid.uuid4().hex[:12]}"
        retries = max(1, _envi("DBCSR_TPU_TORCH_FLEET_RETRIES", 3))
        backoff = _envf("DBCSR_TPU_TORCH_FLEET_BACKOFF_S", 0.05)
        timeout = _envf("DBCSR_TPU_TORCH_FLEET_SUBMIT_TIMEOUT_S", 10.0)
        payload = dict(body, session=session_id, request_id=rid,
                       wait=wait, timeout_s=timeout_s)
        last_exc: Optional[Exception] = None
        for attempt in range(retries):
            if not w.routable():
                break  # dead binding: failover moves the session
            try:
                if _faults.active():
                    _faults.maybe_inject(
                        "fleet_route", tenant=b["tenant"],
                        worker=w.name, request_id=rid)
                info = self._call(w.url, "/serve/submit", payload,
                                  timeout + (timeout_s if wait else 0.0))
            except urllib.error.HTTPError as exc:
                if exc.code == 429:  # shed: structured, not a failure
                    info = json.loads(exc.read().decode() or "{}")
                    self._land(rid, b["tenant"], w.name,
                               info.get("state", "shed"))
                    self._metric("routed", w.name)
                    return info
                last_exc = exc
                self._metric("retried", w.name)
            except Exception as exc:
                last_exc = exc
                self._metric("retried", w.name)
                # a timed-out attempt is AMBIGUOUS — the worker may
                # hold the request.  Probe before re-sending: a known
                # id is polled, never duplicated.
                known = self._status_probe(w, rid, timeout)
                if known is not None:
                    self._land(rid, b["tenant"], w.name,
                               known.get("state", "?"))
                    self._metric("routed", w.name)
                    return (self.wait(rid, timeout=timeout_s)
                            if wait else known)
            else:
                self._land(rid, b["tenant"], w.name,
                           info.get("state", "?"))
                self._metric("routed", w.name)
                return info
            time.sleep(backoff * (2 ** attempt))
        self._note_miss(w)
        self._metric("failed", w.name)
        raise RouteError(
            f"request {rid} not landed on {w.name} after {retries} "
            f"attempts: {type(last_exc).__name__ if last_exc else 'unroutable'}"
            f": {last_exc}")

    def _status_probe(self, w: Worker, rid: str,
                      timeout: float) -> Optional[dict]:
        try:
            return self._call(
                w.url, f"/serve/status?request_id={rid}", None, timeout)
        except Exception:
            return None

    def _land(self, rid: str, tenant: str, worker: str,
              state: str) -> None:
        with self._lock:
            row = self.ledger.get(rid)
            if row is None:
                row = self.ledger[rid] = {"tenant": tenant,
                                          "landings": {}}
                while len(self.ledger) > _LEDGER_MAX:
                    self.ledger.popitem(last=False)
            row["landings"][worker] = state

    def wait(self, request_id: str, timeout: float = 60.0) -> dict:
        """Poll the owning worker until the request is terminal (or
        the deadline passes); returns the last info payload seen and
        updates the ledger.  A request the ledger already holds
        settled (e.g. a dead worker's tombstone backfill) returns
        without polling — its worker may no longer exist."""
        with self._lock:
            row = self.ledger.get(request_id)
        if row is None:
            raise KeyError(f"unknown request {request_id}")
        for wname, st in row["landings"].items():
            if st in SETTLED_STATES:
                return {"request_id": request_id, "state": st,
                        "settled_by": wname}
        worker = next(reversed(row["landings"]))
        w = self.workers[worker]
        http_to = _envf("DBCSR_TPU_TORCH_FLEET_SUBMIT_TIMEOUT_S", 10.0)
        deadline = time.time() + timeout
        info: dict = {"request_id": request_id, "state": "?"}
        while time.time() < deadline:
            probe = self._status_probe(w, request_id, http_to)
            if probe is not None:
                info = probe
                if info.get("state") in DONE_STATES:
                    break
            time.sleep(0.02)
        self._land(request_id, row["tenant"], worker,
                   info.get("state", "?"))
        return info

    # ------------------------------------------------------------ failover

    def drain(self, name: str, timeout_s: float = 30.0) -> dict:
        """Drain one worker (admission closes, queued requests
        journal); the worker stays up but unroutable until `rejoin`."""
        w = self.workers[name]
        resp = self._call(w.url, "/serve/drain",
                          {"timeout_s": timeout_s,
                           "journal": w.journal},
                          timeout_s + 10.0)
        w.draining = True
        # reconcile the ledger while the drained worker still
        # remembers: every routed-here request's fate (done, failed,
        # or journaled for the peer replay) is recorded NOW — an
        # upgrade restarts this process and loses that memory
        http_to = _envf("DBCSR_TPU_TORCH_FLEET_SUBMIT_TIMEOUT_S", 10.0)
        with self._lock:
            mine = [rid for rid, row in self.ledger.items()
                    if next(reversed(row["landings"]), None) == name
                    and not any(st in DONE_STATES
                                for st in row["landings"].values())]
        for rid in mine:
            probe = self._status_probe(w, rid, http_to)
            if probe is not None:
                tenant = self.ledger.get(rid, {}).get("tenant", "?")
                self._land(rid, tenant, name,
                           probe.get("state", "?"))
        self.observe()
        return resp

    def failover(self, dead: str, target: Optional[str] = None) -> dict:
        """Exactly-once failover of ``dead``'s sessions and journal
        onto a surviving peer (see module docstring).  Raises
        `RouteError` when no surviving routable peer exists; an
        injected ``fleet_handoff`` fault aborts BEFORE any replay
        lands (the journal survives for the retry)."""
        from dbcsr_tpu_torch.serve import engine as _engine

        dw = self.workers[dead]
        if target is None:
            cands = [w for w in self.workers.values()
                     if w.name != dead and w.routable()]
            if not cands:
                raise RouteError(f"no surviving peer to fail {dead} "
                                 "over to")
            tw = cands[0]
        else:
            tw = self.workers[target]
        if _faults.active():
            _faults.maybe_inject("fleet_handoff", worker=dead,
                                 target=tw.name)
        timeout = _envf("DBCSR_TPU_TORCH_FLEET_SUBMIT_TIMEOUT_S", 10.0)
        # the dead worker's pending set, and the ids the ledger knows
        # completed elsewhere (a re-routed request journaled twice):
        # those are tombstoned by the target, never re-run
        pending: set = set()
        tombstoned: set = set()
        if dw.journal and os.path.exists(dw.journal):
            sub, done = _engine.journal_ids(dw.journal)
            pending = sub - done
            tombstoned = sub & done
        # the dead worker can no longer be polled, but its journal
        # tombstones prove which of its requests reached a terminal
        # state — backfill the ledger so the exactly-once audit does
        # not call completed-then-crashed work unresolved
        for rid in tombstoned:
            with self._lock:
                row = self.ledger.get(rid)
                settled = row is not None and any(
                    st in SETTLED_STATES
                    for st in row["landings"].values())
            if row is not None and not settled:
                self._land(rid, row["tenant"], dead, "done")
        with self._lock:
            skip = sorted(
                rid for rid in pending
                if any(st == "done" for st in
                       self.ledger.get(rid, {}).get("landings", {})
                       .values()))
        # re-pin the dead worker's sessions on the target under the
        # SAME ids (the journal lines name them), re-creating their
        # recorded deterministic state
        repinned: List[str] = []
        collided: List[str] = []
        for sid, b in list(self.sessions.items()):
            if b["worker"] != dead:
                continue
            try:
                self._call(tw.url, "/serve/session/open",
                           {"tenant": b["tenant"], "session_id": sid},
                           timeout)
            except urllib.error.HTTPError as exc:
                if exc.code == 409:
                    # session-name collision on the peer: never re-pin
                    # across tenants (the engine-side replay guard
                    # skips these lines too)
                    collided.append(sid)
                    continue
                raise
            for spec in b["matrices"]:
                self._call(tw.url, "/serve/matrix",
                           dict(spec, session=sid), timeout)
            for entry in b["entries"]:
                self._call(tw.url, "/serve/stage",
                           {"session": sid, "entry": entry}, timeout)
            b["worker"] = tw.name
            self.affinity[b["tenant"]] = tw.name
            repinned.append(sid)
        replayed: List[str] = []
        if dw.journal and os.path.exists(dw.journal):
            resp = self._call(tw.url, "/serve/replay",
                              {"journal": dw.journal,
                               "skip_ids": skip}, timeout)
            replayed = list(resp.get("replayed") or ())
        for rid in replayed:
            tenant = self.ledger.get(rid, {}).get("tenant", "?")
            self._land(rid, tenant, tw.name, "replayed")
        from dbcsr_tpu_torch.obs import metrics as _metrics

        _metrics.counter(
            "dbcsr_tpu_fleet_failovers_total",
            "exactly-once failovers (dead/drained worker's journal "
            "replayed on a surviving peer)",
        ).inc(worker=dead, target=tw.name)
        if replayed:
            _metrics.counter(
                "dbcsr_tpu_fleet_replayed_total",
                "journaled requests landed on a peer by fleet "
                "failover, deduplicated by request id",
            ).inc(len(replayed), worker=tw.name)
        self._publish("fleet_failover", {
            "worker": dead, "target": tw.name,
            "pending": len(pending), "skipped": len(skip),
            "replayed": len(replayed),
            "hint": "the dead worker's journal replayed on the target"})
        return {"target": tw.name, "pending": sorted(pending),
                "skipped": skip, "replayed": replayed,
                "repinned": repinned, "collided": collided}

    def settle_replayed(self, replayed: List[str], worker: str,
                        timeout: float = 60.0) -> None:
        """Wait until every failover-replayed id is terminal on the
        target (their tombstones land in the dead worker's journal as
        they finish — `rolling_restart` requires this before the dead
        worker may respawn onto the same journal path)."""
        for rid in replayed:
            with self._lock:
                row = self.ledger.get(rid)
            tenant = row["tenant"] if row else "?"
            self._land(rid, tenant, worker, "replayed")
            info = self.wait(rid, timeout=timeout)
            if info.get("state") not in SETTLED_STATES:
                raise RouteError(
                    f"replayed request {rid} not settled on "
                    f"{worker}: {info.get('state')}")

    # -------------------------------------------------------------- audit

    def audit(self) -> dict:
        """The exactly-once evidence: every ledger id's landings,
        plus the violation lists the fleet chaos case asserts empty —
        ``duplicated`` (a ``done`` landing on MORE than one worker)
        and ``unresolved`` (no terminal landing anywhere)."""
        with self._lock:
            snap = {rid: {"tenant": row["tenant"],
                          "landings": dict(row["landings"])}
                    for rid, row in self.ledger.items()}
        duplicated = sorted(
            rid for rid, row in snap.items()
            if sum(1 for st in row["landings"].values()
                   if st == "done") > 1)
        unresolved = sorted(
            rid for rid, row in snap.items()
            if not any(st in SETTLED_STATES
                       for st in row["landings"].values()))
        return {"requests": snap, "duplicated": duplicated,
                "unresolved": unresolved}

    def snapshot(self) -> dict:
        return {
            "workers": {n: w.snapshot()
                        for n, w in self.workers.items()},
            "affinity": dict(self.affinity),
            "sessions": {sid: {"tenant": b["tenant"],
                               "worker": b["worker"]}
                         for sid, b in self.sessions.items()},
            "ledger": len(self.ledger),
        }
