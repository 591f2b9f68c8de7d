"""Fleet supervisor: N serve workers as OS processes, one plane.

Counterpart of `dbcsr_tpu/serve/fleet.py`.  Spawns ``n`` worker
processes (``python -m dbcsr_tpu_torch.serve.fleet --worker``, fresh
interpreters started by `subprocess`, never forked from the caller),
each running its own serve engine on ``device`` and its own obs
endpoint, wired for fault tolerance:

* ``DBCSR_TPU_TORCH_OBS_PORT`` -- a distinct port per worker (the obs
  server binds it at import);
* ``DBCSR_TPU_TORCH_SERVE_JOURNAL`` -- a per-worker journal under the
  fleet's workdir: the replay handle `serve.router.FleetRouter.failover`
  hands to a surviving peer;
* ``DBCSR_TPU_TORCH_SERVE_WAL=1`` -- write-ahead journaling
  (`serve.engine.wal_enabled`): every admitted by-name request is on
  disk before it runs, so even a SIGKILL loses nothing;
* ``DBCSR_TPU_TORCH_FLEET_PEERS`` -- the sibling URLs, for the
  fleet-shared product-cache tier (`serve.product_cache.peer_lookup`);
* ``--device`` and ``--config <json>`` on the worker's command line: the
  engine's device, and config fields (the port's config reads no
  environment variable): ``serve_coalesce`` off by default, per-request
  execution, so a journal replay on a peer reproduces a clean run bit
  for bit, and whatever the caller adds (the quotas, say).

Several workers may share one card: each is its own process with its
own CUDA context.  A worker asked for ``cuda`` on a host without a card
fails to start (`start` raises), and never serves from the CPU.

`rolling_restart` is the zero-loss upgrade path: drain one worker, fail
its journal over onto a peer, wait for every replayed request's
terminal state, restart the worker, rejoin, then the next.

``python -m dbcsr_tpu_torch.serve.fleet --demo [--device cpu]`` boots a
2-worker fleet, routes one multiply, prints the cluster snapshot and
exits.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from typing import Dict, Optional


def free_port() -> int:
    """An OS-assigned free TCP port (bind-to-0 probe)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Fleet:
    """Supervisor for ``n`` worker processes (see module docstring).

    Use as a context manager or call `stop()`; the workdir (journals)
    is the caller's to keep or clean — journals ARE the crash
    evidence."""

    def __init__(self, n: int = 2, workdir: Optional[str] = None,
                 env: Optional[dict] = None, device: Optional[str] = None,
                 config: Optional[dict] = None):
        from dbcsr_tpu_torch.device import default_device, resolve_device

        # the card unless the caller asks for the CPU; a CUDA device on
        # a host without one raises here, before any worker starts
        self.device = str(device if device is not None else default_device())
        resolve_device(self.device)
        self.config = {"serve_coalesce": False, **(config or {})}
        self.workdir = workdir or tempfile.mkdtemp(prefix="dbcsr-torch-fleet-")
        self.extra_env = dict(env or {})
        self.specs: Dict[str, dict] = {}
        self.procs: Dict[str, subprocess.Popen] = {}
        # seconds from spawn to a running engine, per worker (last start)
        self.start_s: Dict[str, float] = {}
        self._t_spawn: Dict[str, float] = {}
        for i in range(n):
            name = f"w{i}"
            port = free_port()
            self.specs[name] = {
                "port": port,
                "url": f"http://127.0.0.1:{port}",
                "journal": os.path.join(self.workdir,
                                        f"journal-{name}.jsonl"),
            }

    # ----------------------------------------------------------- lifecycle

    def start(self, timeout: float = 30.0) -> None:
        for name in self.specs:
            self._spawn(name)
        self.wait_ready(timeout=timeout)

    def _spawn(self, name: str) -> None:
        spec = self.specs[name]
        env = dict(os.environ)
        env.update({
            "DBCSR_TPU_TORCH_OBS_PORT": str(spec["port"]),
            "DBCSR_TPU_TORCH_SERVE_JOURNAL": spec["journal"],
            "DBCSR_TPU_TORCH_SERVE_WAL": "1",
            "DBCSR_TPU_TORCH_FLEET_PEERS": ",".join(
                s["url"] for n2, s in self.specs.items() if n2 != name),
        })
        env.update(self.extra_env)
        # the worker runs from the fleet workdir (journals land there)
        # — make the package importable from wherever the parent runs
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
        self._t_spawn[name] = time.time()
        with open(os.path.join(self.workdir, f"{name}.log"), "ab") as log:
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-m", "dbcsr_tpu_torch.serve.fleet", "--worker",
                 "--device", self.device, "--config", json.dumps(self.config)],
                env=env, cwd=self.workdir, stdin=subprocess.DEVNULL,
                stdout=log, stderr=subprocess.STDOUT)

    def wait_ready(self, names=None, timeout: float = 30.0) -> None:
        """Block until each worker's heartbeat reports a RUNNING
        engine — an answering port alone is not readiness (the obs
        endpoint binds seconds before the engine finishes booting)."""
        deadline = time.time() + timeout
        for name in (names or self.specs):
            url = self.specs[name]["url"]
            while True:
                try:
                    with urllib.request.urlopen(
                            url + "/serve/heartbeat", timeout=1.0) as r:
                        if json.loads(r.read().decode()).get("engine"):
                            self.start_s[name] = time.time() - self._t_spawn[name]
                            break
                except Exception:
                    pass
                proc = self.procs.get(name)
                if proc is not None and proc.poll() is not None:
                    raise RuntimeError(
                        f"worker {name} exited rc={proc.returncode} "
                        f"before becoming ready (log: {self.workdir}/{name}.log)")
                if time.time() > deadline:
                    raise TimeoutError(
                        f"worker {name} not ready in {timeout}s")
                time.sleep(0.05)

    def kill(self, name: str, sig: int = signal.SIGKILL) -> None:
        """Kill one worker (default SIGKILL — the crash the journal
        exists for; SIGTERM triggers the worker's graceful drain)."""
        proc = self.procs.get(name)
        if proc is not None and proc.poll() is None:
            proc.send_signal(sig)
            proc.wait(timeout=30)

    def respawn(self, name: str, timeout: float = 30.0) -> None:
        """Restart a dead worker on its original port/journal.  Its
        startup replay retires a fully-tombstoned journal; lines a
        failover has NOT yet landed elsewhere stay journaled (a fresh
        process has no sessions, so nothing replays twice)."""
        self.kill(name, signal.SIGKILL)
        self._spawn(name)
        self.wait_ready(names=[name], timeout=timeout)

    def stop(self) -> None:
        for name, proc in self.procs.items():
            if proc.poll() is None:
                proc.terminate()
        deadline = time.time() + 15
        for proc in self.procs.values():
            try:
                proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)

    def __enter__(self) -> "Fleet":
        try:
            self.start()
        except BaseException:
            self.stop()
            raise
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- routing

    def router(self):
        """A `serve.router.FleetRouter` over this fleet's table."""
        from dbcsr_tpu_torch.serve.router import FleetRouter

        return FleetRouter([(name, spec["url"], spec["journal"])
                            for name, spec in self.specs.items()])

    def rolling_restart(self, router, timeout: float = 60.0) -> dict:
        """Upgrade the whole fleet one worker at a time with zero
        request loss: drain → failover (journal replays on a peer) →
        settle → restart → rejoin, then the next worker."""
        report: Dict[str, dict] = {}
        for name in list(self.specs):
            drained = router.drain(name, timeout_s=timeout)
            moved = router.failover(name)
            router.settle_replayed(moved["replayed"], moved["target"],
                                   timeout=timeout)
            self.kill(name, signal.SIGTERM)
            self._spawn(name)
            self.wait_ready(names=[name], timeout=timeout)
            router.rejoin(name)
            report[name] = {"drained": drained.get("journaled", 0),
                            "replayed": moved["replayed"],
                            "target": moved["target"]}
        return report


# ------------------------------------------------------------------ worker

def _worker_main(device: str, config: Optional[dict] = None) -> int:
    """One fleet worker: obs endpoint + serve engine on ``device``;
    SIGTERM drains to the env-pinned journal and exits cleanly.  A CUDA
    device on a host without one raises before the engine exists: the
    worker exits without ever reporting a running engine."""
    from dbcsr_tpu_torch.core.config import set_config
    from dbcsr_tpu_torch.device import set_default_device
    from dbcsr_tpu_torch.obs import server as _obs_server
    from dbcsr_tpu_torch.serve import engine as _engine

    eng = _engine.get_engine(start=False, device=device)
    set_default_device(device)
    set_config(**(config or {}))
    eng.start()
    # the env activation at import already bound the port: restarting
    # here would drop connections the supervisor's readiness probe
    # already opened
    if _obs_server.url() is None:
        _obs_server.start()
    stop = {"flag": False}

    def _term(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _term)
    while not stop["flag"]:
        time.sleep(0.1)
    try:
        eng.drain(timeout=30.0)
    finally:
        _obs_server.stop()
    return 0


def _demo(n: int, device: Optional[str]) -> int:
    fleet = Fleet(n=n, device=device)
    with fleet:
        router = fleet.router()
        router.check()
        sid = router.open_session("demo")
        router.matrix(sid, name="a", row_blk=[4, 4, 4], seed=1)
        router.matrix(sid, name="b", row_blk=[4, 4, 4], seed=2)
        router.matrix(sid, name="c", row_blk=[4, 4, 4],
                      occupation=0.0, seed=3)
        info = router.submit(sid, op="multiply", a="a", b="b", c="c",
                             wait=True, timeout_s=30.0)
        print(json.dumps({"request": info,
                          "fleet": router.snapshot(),
                          "audit": {k: v for k, v in
                                    router.audit().items()
                                    if k != "requests"}},
                         indent=2, default=str))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dbcsr_tpu_torch.serve.fleet",
        description="fleet worker entrypoint / demo supervisor")
    ap.add_argument("--worker", action="store_true",
                    help="run as a fleet worker process (internal)")
    ap.add_argument("--demo", action="store_true",
                    help="boot a fleet, route one multiply, print "
                         "the cluster snapshot, exit")
    ap.add_argument("-n", type=int, default=2,
                    help="fleet size for --demo (default 2)")
    ap.add_argument("--device", default=None,
                    help="the workers' device (default: the card, cuda)")
    ap.add_argument("--config", default="{}",
                    help="a worker's config fields, as a JSON object")
    args = ap.parse_args(argv)
    if args.worker:
        return _worker_main(args.device or "cuda", json.loads(args.config))
    if args.demo:
        return _demo(args.n, args.device)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
