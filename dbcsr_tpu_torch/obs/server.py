"""Opt-in HTTP introspection and serving endpoint.

Counterpart of `dbcsr_tpu/obs/server.py`.  With
``DBCSR_TPU_TORCH_OBS_PORT=<port>`` set at import (or `start()`
called), the process serves its live observability state and the
serving plane over stdlib ``http.server`` -- a daemon thread, no cost
when off:

====================  ==================================================
route                 payload
====================  ==================================================
``/metrics``          Prometheus text exposition (`metrics.
                      prometheus_text()`), then the kernel wrappers'
                      own counts (`kernel_counts_text`)
``/healthz``          `health.verdict()` JSON; HTTP 200 for OK/
                      DEGRADED, 503 for CRITICAL (load-balancer
                      convention)
``/flight``           the flight-recorder ring (`flight.records()`)
``/events``           the event-bus ring; ``?product_id=…``,
                      ``?kind=…``, ``?limit=N``
``/timeseries``       the telemetry history (`obs.timeseries`):
                      ``?metric=&since=&until=&agg=&tier=`` + any other
                      param as a label matcher
``/rca``              ranked causal reports, change-points, the ledger
``/profile/diff``     differential profile between two epochs
``/slo``              `obs.slo` burn rates and the ``slo`` component
``/cluster``          the fleet: every sibling process's endpoint
                      scraped and merged with per-process labels;
                      ``?format=prom`` (default) or ``json``,
                      ``?ports=`` / ``?n=``
``/serve/submit``     POST one request (``session``, ``a``/``b``/``c``
                      names, ``alpha``/``beta``/``op``/``priority``/
                      ``deadline_s``, optional ``wait`` +
                      ``timeout_s``); 503 without an engine, 429 with
                      the structured rejection when shed
``/serve/status``     engine snapshot; ``?request_id=`` one ticket
``/serve/tenants``    per-tenant counters, queue load, p50/p95 latency
``/serve/heartbeat``  fleet liveness (never 503s on a missing engine)
``/serve/checksum``   ``?session=&name=`` one matrix's checksum
``/serve/cache``      ``?digest=`` one product-cache entry (the fleet
                      tier's wire call)
``/tune/promotions``  this process's origin promotions (``?kind=``)
``/serve/session/open``, ``/serve/matrix``, ``/serve/stage``,
``/serve/drain``, ``/serve/replay``: POST, the fleet router's calls
``/usage``            the tenant cost-attribution rollup (``?top=N``)
``/``                 route index JSON
====================  ==================================================

Matrices are made on the engine's device by spec (``/serve/matrix``:
seeded random or empty), so no operand bytes travel over HTTP.

**Multihost**: N processes sharing one port value bind ``base_port +
process_index``; when the index is unknown at activation the server
starts on the base port best-effort and `parallel.multihost` calls
`rebind()` once the world forms.  ``/cluster`` takes the world size
from an initialized `torch.distributed` group.

Loopback by default (``DBCSR_TPU_TORCH_OBS_HOST``, default
``127.0.0.1``): this is an introspection port, not a public API.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from dbcsr_tpu_torch.obs import shard as _shard

_lock = threading.Lock()
_server: "ObsServer | None" = None
# /serve/stage's per-process materialization memo: (tenant, digest) ->
# matrix (the loadtest mat_cache contract — repeated digests reuse ONE
# object so the value-digest memo and product cache behave as live)
_stage_cache: dict = {}
# remembered when an early start() could not bind (index unknown and
# the base port was taken by another rank): rebind() retries with the
# resolved offset
_pending_base: int | None = None


def kernel_counts_text() -> str:
    """The stack kernels' wrappers' own counts since their last reset, as
    Prometheus counters: each wrapper's launches of its kernel, and the
    calls of each plain version.  A process behind this endpoint (a fleet
    worker) shows by them which kernels its stacks ran."""
    from dbcsr_tpu_torch.acc import crosspack_kernel, stack_kernel

    launches = {"smm_stack": stack_kernel.launches,
                "smm_superstack": stack_kernel.superstack_launches,
                "smm_crosspack": crosspack_kernel.launches_cross,
                "smm_crosspack_resident": crosspack_kernel.launches_resident}
    plain = {"smm_stack": stack_kernel.plain_calls,
             "smm_crosspack": crosspack_kernel.plain_calls}
    lines = ["# HELP dbcsr_tpu_kernel_launches_total launches of each stack kernel",
             "# TYPE dbcsr_tpu_kernel_launches_total counter"]
    lines += [f'dbcsr_tpu_kernel_launches_total{{kernel="{k}"}} {n}'
              for k, n in launches.items()]
    lines += ["# HELP dbcsr_tpu_kernel_plain_calls_total calls of each stack kernel's "
              "plain version",
              "# TYPE dbcsr_tpu_kernel_plain_calls_total counter"]
    lines += [f'dbcsr_tpu_kernel_plain_calls_total{{kernel="{k}"}} {n}'
              for k, n in plain.items()]
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "dbcsr-tpu-torch-obs/1"

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass

    def _send(self, body: str, content_type: str, code: int = 200) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, obj, code: int = 200) -> None:
        self._send(json.dumps(obj, default=str), "application/json", code)

    def do_GET(self):  # noqa: N802 — http.server API
        try:
            url = urlparse(self.path)
            route = url.path.rstrip("/") or "/"
            if route == "/metrics":
                from dbcsr_tpu_torch.obs import metrics

                self._send(metrics.prometheus_text() + kernel_counts_text(),
                           "text/plain; version=0.0.4")
            elif route == "/healthz":
                from dbcsr_tpu_torch.obs import health

                v = health.verdict()
                self._send_json(
                    v, code=503 if v["status"] == health.CRITICAL else 200)
            elif route == "/flight":
                from dbcsr_tpu_torch.obs import flight

                self._send_json(flight.records())
            elif route == "/events":
                from dbcsr_tpu_torch.obs import events

                q = parse_qs(url.query)
                limit = None
                if "limit" in q:
                    try:
                        limit = int(q["limit"][0])
                    except ValueError:
                        pass
                self._send_json(events.records(
                    product_id=q.get("product_id", [None])[0],
                    kind=q.get("kind", [None])[0], limit=limit))
            elif route == "/timeseries":
                self._timeseries(parse_qs(url.query))
            elif route == "/rca":
                self._rca(parse_qs(url.query))
            elif route == "/profile/diff":
                self._profile_diff(parse_qs(url.query))
            elif route == "/slo":
                from dbcsr_tpu_torch.obs import slo

                self._send_json({"objectives": slo.evaluate(),
                                 "component": slo.component()})
            elif route == "/cluster":
                self._cluster(parse_qs(url.query))
            elif route == "/serve/status":
                q = parse_qs(url.query)
                self._serve_status(q.get("request_id", [None])[0])
            elif route == "/serve/heartbeat":
                # fleet liveness probe: answers whether THIS process is
                # alive and routable — never 503s on a missing engine
                # (the router reads `engine`/`draining`, it does not
                # infer them from the status code)
                from dbcsr_tpu_torch.serve import engine as _serve

                eng = _serve.current_engine()
                self._send_json({
                    "pid": os.getpid(),
                    "t_unix": time.time(),
                    "engine": eng is not None and eng.running(),
                    "draining": bool(eng.draining) if eng else False,
                    "queue_depth": eng.queue.depth() if eng else 0,
                })
            elif route == "/serve/checksum":
                self._serve_checksum(parse_qs(url.query))
            elif route == "/serve/cache":
                # fleet-shared product-cache tier: one entry by digest
                # handle (serve.product_cache.peer_lookup's wire call)
                from dbcsr_tpu_torch.serve import product_cache as _pcache

                q = parse_qs(url.query)
                dig = q.get("digest", [None])[0]
                payload = _pcache.export_entry(dig) if dig else None
                if payload is None:
                    self._send_json({"found": False}, code=404)
                else:
                    self._send_json(dict(payload, found=True))
            elif route == "/tune/promotions":
                # fleet-shared tuning tier: this process's ORIGIN
                # promotions (never re-exported adoptions), filtered to
                # the caller's device kind (tune.store.peer_sync's
                # wire call)
                from dbcsr_tpu_torch.tune import store as _tstore

                q = parse_qs(url.query)
                payload = _tstore.export_promotions(
                    kind=q.get("kind", [None])[0])
                if not payload.get("rows"):
                    self._send_json(dict(payload, found=False), code=404)
                else:
                    self._send_json(dict(payload, found=True))
            elif route == "/serve/tenants":
                eng = self._serve_engine()
                if eng is None:
                    return
                self._send_json(eng.tenants())
            elif route == "/usage":
                from dbcsr_tpu_torch.obs import attribution

                q = parse_qs(url.query)
                try:
                    top = int(q.get("top", ["5"])[0])
                except ValueError:
                    top = 5
                self._send_json(attribution.usage(top=top))
            elif route == "/":
                self._send_json({
                    "routes": ["/metrics", "/healthz", "/flight",
                               "/events?product_id=&kind=&limit=",
                               "/timeseries?metric=&since=&agg=&tier=",
                               "/rca?limit=&ledger=",
                               "/profile/diff?a=&b=&top=",
                               "/slo",
                               "/cluster?format=prom|json&ports=&n=",
                               "/serve/submit (POST)",
                               "/serve/status?request_id=",
                               "/serve/tenants",
                               "/serve/heartbeat",
                               "/serve/checksum?session=&name=",
                               "/serve/cache?digest=",
                               "/tune/promotions?kind=",
                               "/serve/session/open (POST)",
                               "/serve/matrix (POST)",
                               "/serve/stage (POST)",
                               "/serve/drain (POST)",
                               "/serve/replay (POST)",
                               "/usage?top="],
                    "process_index": _server.process_index
                    if _server else None,
                })
            else:
                self._send_json({"error": f"no route {route}"}, code=404)
        except Exception as exc:  # introspection must never kill the job
            try:
                self._send_json(
                    {"error": f"{type(exc).__name__}: {exc}"}, code=500)
            except Exception:
                pass

    # -------------------------------------------------- telemetry history

    def _timeseries(self, q: dict) -> None:
        """``/timeseries``: query the live store.  Reserved params:
        ``metric``, ``since``, ``until``, ``agg``, ``tier``; every
        OTHER param is a label matcher (``?metric=…&driver=xla``).
        Without ``metric`` the known series are listed."""
        from dbcsr_tpu_torch.obs import timeseries

        metric = q.get("metric", [None])[0]
        if not metric:
            self._send_json(timeseries.series_list())
            return
        reserved = ("metric", "since", "until", "agg", "tier", "format")
        labels = {k: v[0] for k, v in q.items() if k not in reserved}

        def num(name):
            raw = q.get(name, [None])[0]
            try:
                return float(raw) if raw not in (None, "") else None
            except ValueError:
                return None

        tier = q.get("tier", ["auto"])[0]
        if tier not in ("auto", "raw"):
            try:
                tier = float(tier)
            except ValueError:
                tier = "auto"
        self._send_json(timeseries.query(
            metric, labels=labels or None, since=num("since"),
            until=num("until"), agg=q.get("agg", [None])[0] or None,
            tier=tier))

    # --------------------------------------------- causal diagnosis plane

    def _rca(self, q: dict) -> None:
        """``/rca``: ranked causal reports + the change ledger + fired
        change-points, versioned by the obs schema (fleet merges key
        on it)."""
        from dbcsr_tpu_torch import obs
        from dbcsr_tpu_torch.obs import changepoint, rca

        limit = None
        try:
            raw = q.get("limit", [None])[0]
            limit = int(raw) if raw else None
        except ValueError:
            pass
        try:
            ledger_n = int(q.get("ledger", ["32"])[0])
        except ValueError:
            ledger_n = 32
        self._send_json({
            "schema": obs.OBS_SCHEMA_VERSION,
            "reports": rca.reports(limit=limit),
            "changepoints": changepoint.changepoints(limit=limit),
            "ledger": rca.ledger(limit=ledger_n),
        })

    def _profile_diff(self, q: dict) -> None:
        """``/profile/diff``: differential profile between two baseline
        snapshots.  ``a``/``b`` accept an epoch number, a negative ring
        index, or ``current``; defaults compare the previous sealed
        epoch against the newest profile state."""
        from dbcsr_tpu_torch.obs import profiler

        def ref(name, default):
            raw = q.get(name, [None])[0]
            if raw in (None, ""):
                return default
            if raw == "current":
                return "current"
            try:
                return int(raw)
            except ValueError:
                return default

        try:
            top = int(q.get("top", ["8"])[0])
        except ValueError:
            top = 8
        a = ref("a", -2)
        b = ref("b", "current")
        d = profiler.diff(a, b, top=top)
        if b == "current" and not d.get("ok"):
            # a young process may have sealed nothing yet; fall back to
            # newest-sealed vs current before giving up
            d = profiler.diff(-1, "current", top=top)
        self._send_json(d)

    # --------------------------------------------------- fleet federation

    def _cluster(self, q: dict) -> None:
        """``/cluster``: scrape every sibling process's endpoint and
        merge into one fleet view with per-process provenance."""
        fmt = q.get("format", ["prom"])[0]
        ports = q.get("ports", [None])[0]
        n = q.get("n", [None])[0]
        peers = _cluster_peers(
            ports=[int(p) for p in ports.split(",") if p] if ports
            else None,
            n=int(n) if n else None)
        if fmt == "json":
            self._send_json(fleet_report(peers))
        else:
            self._send(merge_prometheus(peers), "text/plain; version=0.0.4")

    # ------------------------------------------------------ serving plane

    def _serve_engine(self):
        """The live serving engine, or None (a 503 was sent).  The
        endpoint never CREATES an engine — serving is opt-in."""
        from dbcsr_tpu_torch.serve import engine as _serve

        eng = _serve.current_engine()
        if eng is None:
            self._send_json(
                {"error": "serving plane not running "
                          "(dbcsr_tpu_torch.serve.get_engine() starts it)"},
                code=503)
        return eng

    def _serve_status(self, request_id):
        eng = self._serve_engine()
        if eng is None:
            return
        if request_id:
            req = eng.get_request(request_id)
            if req is None:
                self._send_json(
                    {"error": f"unknown request {request_id}"}, code=404)
                return
            self._send_json(req.info())
            return
        self._send_json(eng.status())

    def do_POST(self):  # noqa: N802 — http.server API
        try:
            url = urlparse(self.path)
            route = url.path.rstrip("/")
            handlers = {
                "/serve/submit": self._serve_submit,
                "/serve/session/open": self._serve_session_open,
                "/serve/matrix": self._serve_matrix,
                "/serve/stage": self._serve_stage,
                "/serve/drain": self._serve_drain,
                "/serve/replay": self._serve_replay,
            }
            handler = handlers.get(route)
            if handler is None:
                self._send_json({"error": f"no POST route {route}"},
                                code=404)
                return
            length = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except ValueError:
                self._send_json({"error": "bad JSON body"}, code=400)
                return
            handler(body)
        except Exception as exc:  # the serve paths must never kill the job
            try:
                self._send_json(
                    {"error": f"{type(exc).__name__}: {exc}"}, code=500)
            except Exception:
                pass

    def _resolve_session(self, body: dict):
        """The session named by ``body`` or None (a 404 was sent)."""
        from dbcsr_tpu_torch.serve import session as _session

        sess = _session.get_session(str(body.get("session", "")))
        if sess is None:
            self._send_json(
                {"error": f"unknown session {body.get('session')!r}"},
                code=404)
        return sess

    def _serve_submit(self, body: dict) -> None:
        eng = self._serve_engine()
        if eng is None:
            return
        sess = self._resolve_session(body)
        if sess is None:
            return
        params = {k: body[k] for k in
                  ("a", "b", "c", "p", "alpha", "beta", "transa",
                   "transb", "filter_eps", "retain_sparsity", "steps",
                   "out")
                  if k in body}
        try:
            req = eng.submit(
                sess, op=str(body.get("op", "multiply")),
                priority=int(body.get("priority", 10)),
                deadline_s=body.get("deadline_s"),
                request_id=body.get("request_id"), **params)
        except KeyError as exc:  # unregistered matrix name
            self._send_json({"error": str(exc.args[0])}, code=404)
            return
        except ValueError as exc:  # unknown op
            self._send_json({"error": str(exc)}, code=400)
            return
        if body.get("wait"):
            req.wait(timeout=float(body.get("timeout_s", 30.0)))
        info = req.info()
        self._send_json(info, code=429 if req.state == "shed" else 200)

    def _serve_session_open(self, body: dict) -> None:
        """Open (or idempotently re-open) a session.  An explicit
        ``session_id`` is what lets the fleet router re-pin a dead
        worker's tenant sessions on a surviving peer under the SAME
        id, so journaled requests resolve; re-opening an id the same
        tenant already holds returns it (idempotent), another tenant's
        id is refused 409 — the session-name-collision guard."""
        eng = self._serve_engine()
        if eng is None:
            return
        tenant = str(body.get("tenant") or "")
        if not tenant:
            self._send_json({"error": "no tenant"}, code=400)
            return
        sid = body.get("session_id")
        if sid is not None:
            from dbcsr_tpu_torch.serve import session as _session

            existing = _session.get_session(str(sid))
            if existing is not None:
                if existing.tenant != tenant:
                    self._send_json(
                        {"error": f"session id {sid!r} is held by "
                                  f"tenant {existing.tenant!r}"},
                        code=409)
                    return
                self._send_json({"session_id": existing.session_id,
                                 "tenant": existing.tenant,
                                 "existing": True})
                return
        sess = eng.open_session(tenant, name=sid)
        self._send_json({"session_id": sess.session_id,
                         "tenant": sess.tenant, "existing": False})

    def _serve_matrix(self, body: dict) -> None:
        """Create a matrix in a session, on its device, by spec --
        ``random`` (the seeded generator: two workers given the same spec
        make bitwise-equal values, the failover re-pinning primitive),
        ``create`` (an empty result target) or, in the port only,
        ``density`` (`models.make_test_density` of a uniform blocking:
        the models' operands).  No operand bytes travel over HTTP."""
        sess = self._resolve_session(body)
        if sess is None:
            return
        name = str(body.get("name") or "")
        row_blk = body.get("row_blk") or []
        col_blk = body.get("col_blk") or row_blk
        if not name or not row_blk:
            self._send_json({"error": "need name and row_blk"}, code=400)
            return
        dtype = str(body.get("dtype", "float64"))
        kind = str(body.get("kind", "random"))
        if kind == "create":
            sess.create(name, row_blk, col_blk, dtype=dtype)
        elif kind == "density":
            from dbcsr_tpu_torch.models import make_test_density

            if len(set(row_blk)) != 1 or col_blk != row_blk:
                self._send_json({"error": "density needs one uniform square blocking"},
                                code=400)
                return
            sess.put(name, make_test_density(
                len(row_blk), int(row_blk[0]), occ=float(body.get("occupation", 0.2)),
                seed=int(body.get("seed", 0)), dtype=dtype, device=sess.device))
        else:
            sess.random(name, row_blk, col_blk, dtype=dtype,
                        occupation=float(body.get("occupation", 0.5)),
                        seed=int(body.get("seed", 0)))
        self._send_json({"ok": True, "session": sess.session_id,
                         "name": name})

    def _serve_stage(self, body: dict) -> None:
        """Stage one workload stream entry: materialize its operands
        into the session (digest-derived seeds — deterministic across
        workers) and return the submit kwargs.  The stage cache is
        per-process and memoizes per (tenant, digest) exactly like the
        loadtest harness's."""
        from dbcsr_tpu_torch.serve import workload as _workload

        sess = self._resolve_session(body)
        if sess is None:
            return
        entry = body.get("entry")
        if not isinstance(entry, dict):
            self._send_json({"error": "no entry"}, code=400)
            return
        kwargs = _workload.stage_entry(sess, entry, _stage_cache)
        self._send_json({"ok": True, "session": sess.session_id,
                         "kwargs": kwargs})

    def _serve_drain(self, body: dict) -> None:
        eng = self._serve_engine()
        if eng is None:
            return
        self._send_json(eng.drain(
            timeout=float(body.get("timeout_s", 30.0)),
            journal_path=body.get("journal")))

    def _serve_replay(self, body: dict) -> None:
        """Replay a journal on THIS worker (the fleet failover target's
        side of the handoff): ``skip_ids`` are request ids the router's
        ledger knows completed elsewhere — tombstoned, never re-run."""
        eng = self._serve_engine()
        if eng is None:
            return
        tickets = eng.replay_journal(
            path=body.get("journal"),
            skip_ids=body.get("skip_ids") or ())
        self._send_json({"replayed": [t.request_id for t in tickets],
                         "count": len(tickets)})

    def _serve_checksum(self, q: dict) -> None:
        """``/serve/checksum?session=&name=``: the scalar checksum of
        one registered matrix (`ops.test_methods.checksum`) — what the
        fleet chaos case compares bitwise across workers."""
        from dbcsr_tpu_torch.ops.test_methods import checksum
        from dbcsr_tpu_torch.serve import session as _session

        sid = q.get("session", [None])[0]
        name = q.get("name", [None])[0]
        sess = _session.get_session(str(sid or ""))
        if sess is None:
            self._send_json({"error": f"unknown session {sid!r}"},
                            code=404)
            return
        try:
            m = sess.get(str(name or ""))
        except KeyError as exc:
            self._send_json({"error": str(exc.args[0])}, code=404)
            return
        self._send_json({"session": sess.session_id, "name": name,
                         "checksum": float(checksum(m))})


class ObsServer:
    """One listening introspection endpoint (daemon thread)."""

    def __init__(self, host: str, port: int, process_index: int):
        self.process_index = process_index
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, name="dbcsr-tpu-torch-obs-server",
            daemon=True)
        self.thread.start()

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def host(self) -> str:
        return self.httpd.server_address[0]

    def close(self) -> None:
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
        except Exception:
            pass


def _host() -> str:
    return os.environ.get("DBCSR_TPU_TORCH_OBS_HOST", "127.0.0.1")


def start(port: int | None = None) -> "ObsServer | None":
    """Start (or restart) the endpoint on ``base port +
    process_index``.  ``port=0`` binds an ephemeral port (tests).
    Returns the server, or None when the bind failed with the process
    index still unknown — `rebind` retries once `init_multihost`
    resolves it."""
    global _server, _pending_base
    if port is None:
        raw = os.environ.get("DBCSR_TPU_TORCH_OBS_PORT")
        if not raw:
            raise ValueError(
                "no port: pass one or set DBCSR_TPU_TORCH_OBS_PORT")
        port = int(raw)
    with _lock:
        if _server is not None:
            _server.close()
            _server = None
        idx = _shard.process_index() or 0
        bind_port = port + idx if port else 0
        try:
            _server = ObsServer(_host(), bind_port, idx)
            _pending_base = port if port else None
        except OSError:
            # base port taken (very likely a sibling rank on this host,
            # our own index not yet knowable): defer to rebind()
            _pending_base = port if port else None
            return None
        return _server


def stop() -> None:
    global _server, _pending_base
    with _lock:
        if _server is not None:
            _server.close()
            _server = None
        _pending_base = None


def running() -> bool:
    return _server is not None


def get() -> "ObsServer | None":
    return _server


def url() -> str | None:
    """The endpoint base URL, or None when not running."""
    s = _server
    return f"http://{s.host}:{s.port}" if s is not None else None


def rebind(process_index: int | None = None) -> None:
    """Settle the endpoint onto its ``base + process_index`` port once
    the world's index is known (called by `init_multihost`, mirroring
    `tracer.rebind`).  No-op when the endpoint was never requested or
    is already on its final port."""
    global _server
    base = _pending_base
    if base is None:
        return
    if process_index is None:
        process_index = _shard.process_index()
    if process_index is None:
        return
    idx = int(process_index)
    with _lock:
        if _server is not None and _server.process_index == idx \
                and _server.port == base + idx:
            return
        if _server is not None:
            _server.close()
            _server = None
        try:
            _server = ObsServer(_host(), base + idx, idx)
        except OSError:
            _server = None


# --------------------------------------------------- fleet federation
#
# The port-offset scheme (each process serves base + index) tells every
# process where its siblings listen; /cluster turns that into one fleet
# view.  The scrape/relabel/merge core is the port's own copy of the
# JAX package's `tools/fleet.py` functions of the same names.

def _fetch(url: str, route: str, timeout: float = 5.0):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url.rstrip("/") + route, timeout=timeout) as r:
            return r.read().decode()
    except urllib.error.HTTPError as exc:  # 503 CRITICAL still has a body
        try:
            return exc.read().decode()
        except Exception:
            return None
    except Exception:
        return None  # unreachable sibling: provenance records the gap


def _fetch_all(peers: list, route: str, timeout: float = 5.0) -> dict:
    """{process: body or None} for one route across every peer, fetched
    concurrently: a partly-down fleet costs one timeout."""
    import concurrent.futures

    if not peers:
        return {}
    with concurrent.futures.ThreadPoolExecutor(max_workers=min(16, len(peers))) as pool:
        futs = [(proc, pool.submit(_fetch, url, route, timeout)) for proc, url in peers]
        return {proc: fut.result() for proc, fut in futs}


_SAMPLE_RE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})?\s+(.+)$")


def _relabel_prometheus(text: str, extra: dict) -> list:
    """Inject provenance labels into every sample line."""
    inject = ",".join(f'{k}="{v}"' for k, v in sorted(extra.items()))
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, labels, value = m.group(1), m.group(2), m.group(3)
        inner = (labels[1:-1] + "," + inject) if labels else inject
        out.append(f"{name}{{{inner}}} {value}")
    return out


def merge_prometheus(peers: list) -> str:
    """One exposition from [(process, url)]: duplicate HELP/TYPE lines
    deduplicated, unreachable peers as ``dbcsr_tpu_cluster_peer_up 0``."""
    lines = ["# HELP dbcsr_tpu_cluster_peer_up fleet peer endpoint "
             "reachability (1 = scraped)",
             "# TYPE dbcsr_tpu_cluster_peer_up gauge"]
    bodies: list = []
    seen: set = set()
    texts = _fetch_all(peers, "/metrics")
    for proc, url in peers:
        text = texts.get(proc)
        lines.append(f'dbcsr_tpu_cluster_peer_up{{process="{proc}",'
                     f'endpoint="{url}"}} {1 if text is not None else 0}')
        if text is None:
            continue
        for line in _relabel_prometheus(text, {"process": str(proc), "endpoint": url}):
            if line.startswith("#"):
                if line in seen:
                    continue
                seen.add(line)
            bodies.append(line)
    return "\n".join(lines + bodies) + "\n"


def fleet_report(peers: list) -> dict:
    """Fleet summary from [(process, url)]: per-process health status,
    components and anomalies, SLO burn, causal-diagnosis rollup, and the
    fleet-worst status (the ``/cluster?format=json`` payload)."""
    healths = _fetch_all(peers, "/healthz")
    slos = _fetch_all(peers, "/slo")
    rcas = _fetch_all(peers, "/rca?limit=1")
    procs: dict = {}
    for proc, url in peers:
        ent: dict = {"endpoint": url, "up": False}
        body = healths.get(proc)
        if body:
            try:
                h = json.loads(body)
                ent.update(up=True, status=h.get("status"),
                           components={k: c.get("status") for k, c in
                                       (h.get("components") or {}).items()},
                           anomalies=h.get("anomalies"))
            except ValueError:
                pass
        slo_body = slos.get(proc)
        if slo_body:
            try:
                ent["slo"] = {n: {"status": r.get("status"), "burn": r.get("burn")}
                              for n, r in (json.loads(slo_body).get("objectives")
                                           or {}).items()}
            except ValueError:
                pass
        rca_body = rcas.get(proc)
        if rca_body:
            try:
                r = json.loads(rca_body)
                reports = r.get("reports") or []
                last = reports[-1] if reports else None
                ent["rca"] = {
                    "schema": r.get("schema"),
                    "changepoints": len(r.get("changepoints") or ()),
                    "reports": len(reports),
                    "top_cause": (last or {}).get("top_cause"),
                    "series": ((last or {}).get("changepoint") or {}).get("series"),
                }
            except ValueError:
                pass
        procs[str(proc)] = ent
    order = {"OK": 0, "DEGRADED": 1, "CRITICAL": 2}
    worst = "OK"
    for ent in procs.values():
        if order.get(ent.get("status"), 0) > order[worst]:
            worst = ent["status"]
    return {"fleet_status": worst, "processes": procs,
            "reachable": sum(1 for e in procs.values() if e["up"]),
            "scraped": len(procs)}


def _world_size():
    """The process count of an initialized `torch.distributed` group,
    or None (no world: the fleet is this process)."""
    import sys

    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return int(dist.get_world_size())
    except Exception:
        pass
    return None


def _cluster_peers(ports: list | None = None,
                   n: int | None = None) -> list:
    """[(index, url)] of the fleet's endpoints.  Explicit ``ports``
    win; else the remembered base port + the world's process count (an
    initialized `torch.distributed` group's size, or ``n``; without
    either the fleet is this process)."""
    host = _host()
    base = _pending_base
    if base is None and _server is not None:
        base = _server.port - _server.process_index
    if ports:
        # provenance must name the REAL process index: with the base
        # port known, index = port - base (so ?ports=9101 on a base
        # of 9100 labels process="1", and subsets stay truthful);
        # ports outside the offset scheme fall back to position
        out = []
        for i, p in enumerate(ports):
            idx = p - base if (base is not None
                               and 0 <= p - base < 4096) else i
            out.append((idx, f"http://{host}:{p}"))
        return out
    if base is None:
        return [(0, url())] if url() else []
    if n is None:
        n = _world_size()
    # no world evidence and no explicit count: the fleet is just this
    # process — fabricating sibling ports would report phantom peers
    # as down and page spuriously on a healthy single-process job
    count = n if n else 1
    return [(i, f"http://{host}:{base + i}") for i in range(count)]


# env activation: DBCSR_TPU_TORCH_OBS_PORT set at import serves the
# endpoint with no code changes anywhere; a bind conflict defers to
# init_multihost's rebind
if os.environ.get("DBCSR_TPU_TORCH_OBS_PORT"):
    try:
        start()
    except (ValueError, OSError):
        pass
