"""The port's fleet router and supervisor (`dbcsr_tpu_torch/serve/router.py`,
`fleet.py`), held against the JAX package's router on the CPU.

* The router runs against stub HTTP workers (stdlib `http.server`, no
  engine): placement, the heartbeat suspicion ladder into the ``fleet``
  health component, `mark_down`, routed submit with retry and the
  ambiguous-timeout probe, exactly-once failover over real journal
  files, the drain reconciliation and `audit`.  Every case runs on both
  packages' routers and must end the same way.
* The fleet-shared product-cache tier against a stub peer (a hit banks
  locally; a miss never cools the peer off; a dead peer costs one
  timeout).
* One real 2-worker fleet on the CPU (``device="cpu"``): SIGKILL the
  session's owner with requests journaled, fail over, and every request
  lands exactly once with the checksums of a clean in-process run; then
  a product-cache hit through the peer tier.

Both packages' faults, metrics, health models and events are reset
around each test.
"""

import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest
import torch

from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.resilience import faults as jax_faults
from dbcsr_tpu.serve import engine as jax_engine
from dbcsr_tpu.serve import router as jax_router

from dbcsr_tpu_torch.obs import events, health, metrics
from dbcsr_tpu_torch.ops.test_methods import checksum
from dbcsr_tpu_torch.resilience import faults
from dbcsr_tpu_torch.serve import engine as port_engine
from dbcsr_tpu_torch.serve import product_cache
from dbcsr_tpu_torch.serve import router as port_router
from dbcsr_tpu_torch.serve import session as port_session
from dbcsr_tpu_torch.serve.fleet import Fleet

PKGS = {
    "port": SimpleNamespace(router=port_router, faults=faults, metrics=metrics,
                            health=health, events=events, engine=port_engine),
    "jax": SimpleNamespace(router=jax_router, faults=jax_faults, metrics=jax_metrics,
                           health=jax_health, events=jax_events, engine=jax_engine),
}


def _reset():
    for p in PKGS.values():
        p.faults.clear()
        p.metrics.reset()
        p.health.reset()
        p.events.clear()
    product_cache.clear()


@pytest.fixture(autouse=True)
def clean_slate(monkeypatch):
    _reset()
    # every router timeout and backoff snappy under stubs, both packages
    for prefix in ("DBCSR_TPU_FLEET", "DBCSR_TPU_TORCH_FLEET"):
        monkeypatch.setenv(f"{prefix}_SUBMIT_TIMEOUT_S", "2.0")
        monkeypatch.setenv(f"{prefix}_HEARTBEAT_TIMEOUT_S", "2.0")
        monkeypatch.setenv(f"{prefix}_BACKOFF_S", "0.01")
    yield
    _reset()


@pytest.fixture(params=["port", "jax"])
def pkg(request):
    return PKGS[request.param]


# ------------------------------------------------------------- stub worker

class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):
        pass

    def _json(self, obj, code=200):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 — http.server API
        st = self.server.stub
        url = urlparse(self.path)
        st.calls.append(url.path)
        if url.path == "/serve/heartbeat":
            if not st.heartbeat_ok:
                self._json({"error": "wedged"}, code=500)
                return
            self._json({"pid": 1, "t_unix": time.time(),
                        "engine": True, "draining": st.draining,
                        "queue_depth": 0})
        elif url.path == "/healthz":
            self._json({"status": st.healthz_status},
                       code=st.healthz_code)
        elif url.path == "/serve/status":
            rid = parse_qs(url.query).get("request_id", [""])[0]
            info = st.known.get(rid)
            if info is None:
                self._json({"error": f"unknown request {rid}"},
                           code=404)
            else:
                self._json(info)
        elif url.path == "/serve/cache":
            dig = parse_qs(url.query).get("digest", [""])[0]
            payload = st.cache.get(dig)
            if payload is None:
                self._json({"found": False}, code=404)
            else:
                self._json(dict(payload, found=True))
        else:
            self._json({"error": "no route"}, code=404)

    def do_POST(self):  # noqa: N802 — http.server API
        st = self.server.stub
        url = urlparse(self.path)
        st.calls.append(url.path)
        length = int(self.headers.get("Content-Length") or 0)
        body = json.loads(self.rfile.read(length) or b"{}")
        if url.path == "/serve/submit":
            rid = body.get("request_id")
            st.submits.append(rid)
            if st.submit_mode == "shed":
                self._json({"request_id": rid, "state": "shed",
                            "outcome": "shed"}, code=429)
                return
            info = {"request_id": rid, "state": "done",
                    "outcome": "ok", "latency_ms": 1.0}
            st.known[rid] = info
            if st.submit_sleep:
                time.sleep(st.submit_sleep)  # past the router timeout
            self._json(info)
        elif url.path == "/serve/session/open":
            st.opens.append(body)
            if st.open_code != 200:
                self._json({"error": "session collision"},
                           code=st.open_code)
                return
            self._json({"session_id": body.get("session_id")
                        or f"{body['tenant']}-auto"})
        elif url.path == "/serve/matrix":
            st.matrices.append(body)
            self._json({"ok": True, "session": body.get("session"),
                        "name": body.get("name")})
        elif url.path == "/serve/stage":
            st.stages.append(body)
            self._json({"ok": True, "kwargs": {}})
        elif url.path == "/serve/replay":
            st.replays.append(body)
            self._json({"replayed": st.replay_result})
        elif url.path == "/serve/drain":
            self._json({"journal": body.get("journal"),
                        "journaled": 0, "completed_inflight": True})
        else:
            self._json({"error": "no route"}, code=404)


class StubWorker:
    """One configurable fake worker endpoint."""

    def __init__(self):
        self.calls = []
        self.heartbeat_ok = True
        self.draining = False
        self.healthz_code = 200
        self.healthz_status = "OK"
        self.submit_mode = "done"
        self.submit_sleep = 0.0
        self.known = {}
        self.cache = {}
        self.submits = []
        self.opens = []
        self.open_code = 200
        self.matrices = []
        self.stages = []
        self.replays = []
        self.replay_result = []
        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        self._srv.stub = self
        self.url = f"http://127.0.0.1:{self._srv.server_port}"
        t = threading.Thread(target=self._srv.serve_forever, daemon=True)
        t.start()

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


@pytest.fixture
def stubs():
    made = []

    def make(n=2):
        made.extend(StubWorker() for _ in range(n))
        return made

    yield make
    for s in made:
        s.stop()


def _router(pkg, workers, journals=None):
    journals = journals or {}
    return pkg.router.FleetRouter([(f"w{i}", s.url, journals.get(f"w{i}"))
                                   for i, s in enumerate(workers)])


def _counter(pkg, name, **labels):
    return sum(v for lab, v in pkg.metrics.counter_items(name)
               if all(lab.get(k) == x for k, x in labels.items()))


# --------------------------------------------------------------- placement
def test_placement_skips_unroutable_healthz_and_sticks(pkg, stubs):
    w0, w1 = stubs(2)
    w0.healthz_code, w0.healthz_status = 503, "CRITICAL"
    r = _router(pkg, [w0, w1])
    sid = r.open_session("alice")
    assert r.sessions[sid]["worker"] == "w1" and r.affinity["alice"] == "w1"
    probes = w1.calls.count("/healthz")
    r.open_session("alice", session_id="alice-2")
    assert w1.calls.count("/healthz") == probes


def test_placement_balances_and_down_costs_nothing(pkg, stubs):
    w0, w1 = stubs(2)
    r = _router(pkg, [w0, w1])
    r.open_session("alice"), r.open_session("bob")
    assert {r.affinity["alice"], r.affinity["bob"]} == {"w0", "w1"}
    r.mark_down("w0")
    n0 = len(w0.calls)
    for t in ("c", "d"):
        r.open_session(t)
    assert len(w0.calls) == n0 and r.affinity["c"] == r.affinity["d"] == "w1"
    r.mark_down("w1")
    with pytest.raises(pkg.router.RouteError):
        r.place("e")
    assert pkg.health.verdict()["components"]["fleet"]["status"] == "CRITICAL"


# ------------------------------------------------------- failure detection
def test_suspicion_ladder_down_then_rejoin(pkg, stubs):
    pkg.events.set_enabled(True)
    w0, w1 = stubs(2)
    r = _router(pkg, [w0, w1])
    w0.heartbeat_ok = False
    r.check()
    assert r.workers["w0"].state == pkg.router.SUSPECT
    r.check(), r.check()
    assert r.workers["w0"].state == pkg.router.DOWN
    up = pkg.metrics.gauge("dbcsr_tpu_fleet_worker_up")
    assert up.value(worker="w0") == 0.0 and up.value(worker="w1") == 1.0
    assert pkg.health.verdict()["components"]["fleet"]["status"] == "DEGRADED"
    assert any(e.get("worker") == "w0" for e in pkg.events.records(kind="worker_down"))
    assert _counter(pkg, "dbcsr_tpu_fleet_worker_down_total", worker="w0") == 1
    w0.heartbeat_ok = True
    r.check()
    assert r.workers["w0"].state == pkg.router.UP
    assert pkg.health.verdict()["components"]["fleet"]["status"] == "OK"


def test_heartbeat_fault_is_a_missed_beat(pkg, stubs):
    (w0,) = stubs(1)
    r = _router(pkg, [w0])
    with pkg.faults.inject_faults("worker_heartbeat:raise,prob=1.0,times=1") as sp:
        r.check()
    assert sp[0].fired == 1 and r.workers["w0"].state == pkg.router.SUSPECT
    r.check()
    assert r.workers["w0"].state == pkg.router.UP


# ----------------------------------------------------------- routed submit
def test_submit_lands_sheds_and_ledgers(pkg, stubs):
    w0, w1 = stubs(2)
    r = _router(pkg, [w0, w1])
    sid = r.open_session("t")
    assert r.submit(sid, request_id="r1", op="multiply")["state"] == "done"
    assert list(r.ledger["r1"]["landings"].values()) == ["done"]
    w0.submit_mode = w1.submit_mode = "shed"
    assert r.submit(sid, request_id="r2", op="multiply")["state"] == "shed"
    audit = r.audit()
    assert audit["unresolved"] == [] and audit["duplicated"] == []
    assert r.snapshot()["ledger"] == 2


def test_ambiguous_timeout_probes_and_never_resubmits(pkg, stubs, monkeypatch):
    monkeypatch.setenv("DBCSR_TPU_FLEET_SUBMIT_TIMEOUT_S", "0.3")
    monkeypatch.setenv("DBCSR_TPU_TORCH_FLEET_SUBMIT_TIMEOUT_S", "0.3")
    w0, w1 = stubs(2)
    r = _router(pkg, [w0, w1])
    sid = r.open_session("t")
    stub = {"w0": w0, "w1": w1}[r.sessions[sid]["worker"]]
    stub.submit_sleep = 1.0
    assert r.submit(sid, request_id="r-ambig", op="multiply")["state"] == "done"
    assert stub.submits == ["r-ambig"] and r.audit()["duplicated"] == []


def test_route_fault_retries_then_exhausts(pkg, stubs, monkeypatch):
    w0, w1 = stubs(2)
    r = _router(pkg, [w0, w1])
    sid = r.open_session("t")
    with pkg.faults.inject_faults("fleet_route:raise,prob=1.0,times=1") as sp:
        assert r.submit(sid, request_id="r1", op="multiply")["state"] == "done"
    assert sp[0].fired == 1
    assert _counter(pkg, "dbcsr_tpu_fleet_requests_total", outcome="retried") >= 1
    monkeypatch.setenv("DBCSR_TPU_FLEET_RETRIES", "2")
    monkeypatch.setenv("DBCSR_TPU_TORCH_FLEET_RETRIES", "2")
    with pkg.faults.inject_faults("fleet_route:raise,prob=1.0"):
        with pytest.raises(pkg.router.RouteError):
            r.submit(sid, request_id="r2", op="multiply")
    assert r.workers[r.sessions[sid]["worker"]].misses >= 1


# ---------------------------------------------------------------- failover
def _journal(path, submitted, tombstoned=(), torn_tail=False):
    with open(path, "w") as fh:
        for rid in submitted:
            fh.write(json.dumps({"request_id": rid, "tenant": "t", "session": "t-s",
                                 "op": "multiply", "params": {}}) + "\n")
        for rid in tombstoned:
            fh.write(json.dumps({"request_id": rid, "replay_done": True}) + "\n")
        if torn_tail:
            fh.write('{"request_id": "r-torn", "op": "mul')


def test_failover_replays_pending_and_repins(pkg, stubs, tmp_path):
    w0, w1 = stubs(2)
    jpath = str(tmp_path / "j-w0.jsonl")
    _journal(jpath, ["r1", "r2"])
    r = _router(pkg, [w0, w1], journals={"w0": jpath})
    r.affinity["t"] = "w0"
    sid = r.open_session("t", session_id="t-s")
    r.matrix(sid, name="a", row_blk=[4], seed=1)
    w1.replay_result = ["r1", "r2"]
    for rid in ("r1", "r2"):
        w1.known[rid] = {"request_id": rid, "state": "done"}
    w0.stop()
    r.mark_down("w0")
    moved = r.failover("w0")
    assert (moved["target"], moved["pending"], moved["replayed"], moved["repinned"]) == \
        ("w1", ["r1", "r2"], ["r1", "r2"], [sid])
    assert w1.opens[-1]["session_id"] == sid and w1.matrices[-1]["name"] == "a"
    r.settle_replayed(moved["replayed"], "w1")
    audit = r.audit()
    assert audit["duplicated"] == [] and audit["unresolved"] == []
    assert _counter(pkg, "dbcsr_tpu_fleet_failovers_total", worker="w0") == 1


def test_duplicate_rid_in_two_journals_lands_once(pkg, stubs, tmp_path):
    w0, w1 = stubs(2)
    jpath = str(tmp_path / "j-w0.jsonl")
    _journal(jpath, ["r-dup", "r-solo"])
    r = _router(pkg, [w0, w1], journals={"w0": jpath})
    r._land("r-dup", "t", "w1", "done")
    w1.replay_result = ["r-solo"]
    w1.known["r-solo"] = {"request_id": "r-solo", "state": "done"}
    w0.stop()
    r.mark_down("w0")
    moved = r.failover("w0")
    assert moved["skipped"] == ["r-dup"] and w1.replays[-1]["skip_ids"] == ["r-dup"]
    r.settle_replayed(moved["replayed"], "w1")
    assert r.audit()["duplicated"] == [] and r.audit()["unresolved"] == []


def test_failover_backfills_tombstones_and_skips_torn_tail(pkg, stubs, tmp_path):
    w0, w1 = stubs(2)
    jpath = str(tmp_path / "j-w0.jsonl")
    _journal(jpath, ["r-done", "r-ok"], tombstoned=["r-done"], torn_tail=True)
    assert pkg.engine.journal_ids(jpath) == ({"r-done", "r-ok"}, {"r-done"})
    r = _router(pkg, [w0, w1], journals={"w0": jpath})
    r._land("r-done", "t", "w0", "queued")
    w1.replay_result = ["r-ok"]
    w1.known["r-ok"] = {"request_id": "r-ok", "state": "done"}
    w0.stop()
    r.mark_down("w0")
    moved = r.failover("w0")
    assert moved["pending"] == ["r-ok"]
    r.settle_replayed(moved["replayed"], "w1")
    assert r.audit()["unresolved"] == []
    info = r.wait("r-done", timeout=1.0)
    assert info["state"] == "done" and info["settled_by"] == "w0"


def test_session_collision_and_handoff_fault(pkg, stubs, tmp_path):
    w0, w1 = stubs(2)
    jpath = str(tmp_path / "j-w0.jsonl")
    _journal(jpath, ["r1"])
    r = _router(pkg, [w0, w1], journals={"w0": jpath})
    r.affinity["alice"] = "w0"
    sid = r.open_session("alice", session_id="shared-name")
    w0.stop()
    r.mark_down("w0")
    with pkg.faults.inject_faults("fleet_handoff:raise,prob=1.0,times=1") as sp:
        with pytest.raises(Exception):
            r.failover("w0")
    assert sp[0].fired == 1 and w1.replays == [] and os.path.exists(jpath)
    w1.open_code = 409
    moved = r.failover("w0")
    assert moved["collided"] == [sid] and moved["repinned"] == []
    assert r.sessions[sid]["worker"] == "w0" and w1.matrices == []


def test_drain_reconciles_ledger(pkg, stubs):
    w0, w1 = stubs(2)
    r = _router(pkg, [w0, w1])
    sid = r.open_session("t")
    owner = r.sessions[sid]["worker"]
    r.submit(sid, request_id="r-pre", op="multiply")
    r.ledger["r-pre"]["landings"][owner] = "queued"
    r.drain(owner)
    assert r.ledger["r-pre"]["landings"][owner] == "done"
    assert not r.workers[owner].routable()
    r.rejoin(owner)
    assert r.workers[owner].routable()


# -------------------------------------------------------- peer cache tier
def test_peer_cache_hit_banks_locally(stubs, monkeypatch):
    (peer,) = stubs(1)
    key = ("multiply", "testkey", 1.0)
    dig = product_cache.digest_of_key(key)
    data = torch.arange(16, dtype=torch.float64).reshape(1, 4, 4)
    ent = product_cache._Entry(None, "t", 10, 0.01, keys=np.zeros(1, np.int64),
                               bins=[((4, 4), data, 1)])
    product_cache._entries[key] = ent
    product_cache._by_digest[dig] = key
    peer.cache[dig] = product_cache.export_entry(dig)
    product_cache.clear()
    monkeypatch.setenv("DBCSR_TPU_TORCH_FLEET_PEERS", peer.url)
    got = product_cache.peer_lookup(key, tenant="t", device="cpu")
    assert got is not None and got.flops == 10 and torch.equal(got.bins[0][1], data)
    n = peer.calls.count("/serve/cache")
    assert product_cache.lookup(key, tenant="t") is got
    assert peer.calls.count("/serve/cache") == n
    assert _counter(PKGS["port"], "dbcsr_tpu_product_cache_total", result="peer_hit") == 1


def test_peer_miss_never_cools_off_and_dead_peer_costs_one_timeout(stubs, monkeypatch):
    (peer,) = stubs(1)
    monkeypatch.setenv("DBCSR_TPU_TORCH_FLEET_PEERS", peer.url)
    assert product_cache.peer_lookup(("k", 1)) is None
    assert product_cache.peer_lookup(("k", 2)) is None
    assert peer.calls.count("/serve/cache") == 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{s.getsockname()[1]}"
    monkeypatch.setenv("DBCSR_TPU_TORCH_FLEET_PEERS", dead)
    monkeypatch.setenv("DBCSR_TPU_TORCH_FLEET_CACHE_TIMEOUT_S", "0.2")
    t0 = time.perf_counter()
    for i in range(3):
        assert product_cache.peer_lookup(("k", 10 + i)) is None
    assert time.perf_counter() - t0 < 2.0
    outcomes = {lab["result"]: v for lab, v in
                metrics.counter_items("dbcsr_tpu_product_cache_total")}
    assert outcomes == {"peer_miss": 2, "peer_error": 1}


# ---------------------------------------------------------- a real fleet
BLK = [4, 4, 4]


def _get(url, route):
    import urllib.request

    with urllib.request.urlopen(url + route, timeout=10) as resp:
        return resp.read()


def _checksum(url, sid, name):
    import urllib.request

    with urllib.request.urlopen(f"{url}/serve/checksum?session={sid}&name={name}",
                                timeout=10) as resp:
        return json.loads(resp.read())["checksum"]


def _clean_run(n):
    """The same products in this process, serialized on the CPU."""
    from dbcsr_tpu_torch.mm.multiply import multiply

    s = port_session.Session("clean", register=False, device="cpu")
    a = s.random("a", BLK, BLK, occupation=0.5, seed=1)
    b = s.random("b", BLK, BLK, occupation=0.5, seed=2)
    out = {}
    for i in range(n):
        c = s.create(f"c{i}", BLK, BLK)
        multiply("N", "N", 1.0, a, b, 0.0, c)
        out[f"c{i}"] = checksum(c)
    s.close()
    return out


def test_two_worker_fleet_sigkill_failover_exactly_once(tmp_path):
    """A 2-worker fleet on the CPU: the owner of a tenant's session is
    SIGKILLed with requests journaled write-ahead; failover replays them
    on the peer exactly once, with a clean run's checksums; then a
    second tenant's repeat on the other worker is served from the peer
    tier of the product cache."""
    with pytest.raises(RuntimeError, match="cuda"):
        if not torch.cuda.is_available():
            Fleet(n=1, device="cuda", workdir=str(tmp_path / "nocuda"))
        else:  # pragma: no cover - a host with a card
            raise RuntimeError("cuda present")
    fl = Fleet(n=2, device="cpu", workdir=str(tmp_path), config={"serve_tenant_bytes": 1 << 30})
    with fl:
        assert set(fl.start_s) == {"w0", "w1"}
        for spec in fl.specs.values():  # the config flag reached each worker
            status = json.loads(_get(spec["url"], "/serve/status"))
            assert status["quotas"]["tenant_bytes"] == 1 << 30
            assert status["coalesce"]["enabled"] is False
        r = fl.router()
        assert r.check() == {"w0": "up", "w1": "up"}
        sid = r.open_session("t", session_id="t-s")
        r.matrix(sid, name="a", row_blk=BLK, occupation=0.5, seed=1)
        r.matrix(sid, name="b", row_blk=BLK, occupation=0.5, seed=2)
        for i in range(3):
            r.matrix(sid, name=f"c{i}", row_blk=BLK, kind="create")
        owner = r.sessions[sid]["worker"]
        peer = "w1" if owner == "w0" else "w0"
        info = r.submit(sid, request_id="req-0", op="multiply", a="a", b="b", c="c0",
                        wait=True, timeout_s=60)
        assert info["state"] == "done"
        # the rest journaled write-ahead, then the owner dies mid-queue:
        # a drain closes its admission first, so they stay journaled
        r.drain(owner, timeout_s=0.1)
        rids = [f"req-{i}" for i in (1, 2)]
        for i, rid in zip((1, 2), rids):
            with open(fl.specs[owner]["journal"], "a") as fh:
                fh.write(json.dumps({"request_id": rid, "session": sid, "tenant": "t",
                                     "op": "multiply", "priority": 10, "deadline_s": None,
                                     "params": {"a": "a", "b": "b", "c": f"c{i}"}}) + "\n")
            r._land(rid, "t", owner, "queued")
        fl.kill(owner)
        r.mark_down(owner)
        moved = r.failover(owner)
        assert moved["target"] == peer and sorted(moved["replayed"]) == rids
        r.settle_replayed(moved["replayed"], peer, timeout=60.0)
        audit = r.audit()
        assert audit["duplicated"] == [] and audit["unresolved"] == []
        clean = _clean_run(3)
        url = fl.specs[peer]["url"]
        for i in (1, 2):
            assert _checksum(url, sid, f"c{i}") == clean[f"c{i}"]
        # the peer tier: the same product on the peer, then asked for by
        # a respawned owner, arrives over HTTP and launches nothing there
        fl.respawn(owner)
        r.rejoin(owner)
        r.affinity["u"] = owner
        sid2 = r.open_session("u", session_id="u-s")
        r.matrix(sid2, name="a", row_blk=BLK, occupation=0.5, seed=1)
        r.matrix(sid2, name="b", row_blk=BLK, occupation=0.5, seed=2)
        r.matrix(sid2, name="c", row_blk=BLK, kind="create")
        info = r.submit(sid2, request_id="req-peer", op="multiply", a="a", b="b", c="c",
                        wait=True, timeout_s=60)
        assert info["state"] == "done" and info["result"]["cached"] == 1
        assert _checksum(fl.specs[owner]["url"], sid2, "c") == clean["c0"]
    assert all(p.poll() is not None for p in fl.procs.values())
