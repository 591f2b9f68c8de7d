"""One run of one cell: set-up, warm-up, the measured window, the check
of the answers against the plain reference, and the result line.

Everything that belongs to one configuration, traffic kind, cell or
metric is a file of its own, found by name under the benchmark's folder:

- ``configs/<config>.json``: the deployment (sizes, patterns, dtype);
- ``workloads/<cell>.json``: its configuration, traffic name, traffic
  kind and the kind's parameters (warm-up, sampling, check limits);
- ``traffic/<kind>.py``: ``setup(run, cfg, params, seed)`` returns a
  state with ``entry`` (the span name of its call into the program),
  ``step(i)``, ``least_s`` (the least device seconds of one step's
  block products, `peaks`), ``release()`` and ``check()``;
- ``metrics/<metric>.py``: ``read(run)`` returns the metric's value, or
  None where the run has nothing to read.

The metrics a cell reports are those of ``BENCHMARK.json`` that name it
(or name no cells): its end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import resource
import sys
import time

import torch

from portbench import program, tracing

PB_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "dbcsr_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(cell: str, pb_dir: str = PB_DIR):
    """(workload, configuration, traffic kind module) of a cell, by name."""
    wl = load_json(os.path.join(pb_dir, "workloads", f"{cell}.json"))
    cfg = load_json(os.path.join(pb_dir, "configs", f"{wl['config']}.json"))
    kind = load_module(os.path.join(pb_dir, "traffic", f"{wl['kind']}.py"),
                       f"portbench_traffic_{wl['kind']}")
    return wl, cfg, kind


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries of ``bench`` that this cell reports."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def _usage() -> tuple:
    """This process's user and system CPU seconds, minor page faults and
    voluntary and involuntary context switches."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return (r.ru_utime, r.ru_stime, r.ru_minflt, r.ru_nvcsw, r.ru_nivcsw)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """What the traffic kinds write and the metric readers read."""

    def __init__(self, device, trace: bool):
        self.device, self.trace = device, trace
        self.call_ms: dict = {}
        self.steps = 0
        self.window_s = self.setup_s = None
        self.counters: dict = {}
        self.window_peak_bytes = 0
        self.alloc_retries = 0
        self.trace_summary = None
        self.state = None

    def span(self, name: str):
        return torch.profiler.record_function(f"portbench:{name}")

    def call(self, name: str, fn, *args, **kw):
        """Call into the program inside the span ``name``; in a traced run
        also time the call on the host clock, the device drained before
        and after."""
        with self.span(name):
            if not self.trace:
                return fn(*args, **kw)
            _sync(self.device)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            _sync(self.device)
            self.call_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return out


def _peak_bytes(cuda: bool, chips: int) -> int:
    """The allocator's peak on the fullest of the run's devices."""
    return max(torch.cuda.max_memory_allocated(i) for i in range(chips)) if cuda else 0


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device, bench: dict,
             t_start: float, pb_dir: str = PB_DIR, log=sys.stderr, chips: int = 1) -> dict:
    """One run; returns the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, with a trace ``breakdown``, and
    ``checks`` last), or raises with what it found (a forbidden module).
    ``device`` is the run's first device; a cell on ``chips`` devices
    places its work on the others itself."""
    device = torch.device(device)
    wl, cfg, kind = load_cell(cell, pb_dir)
    params = wl["params"]
    run = Run(device, trace)
    state = run.state = kind.setup(run, cfg, params, seed)
    for i in range(int(params.get("warm_steps", 1))):
        state.step(-1 - i)
    _sync(device)
    gc.collect()
    cuda = device.type == "cuda"
    setup_peak = _peak_bytes(cuda, chips)
    program.reset_counters()
    for i in range(chips if cuda else 0):
        torch.cuda.reset_peak_memory_stats(i)
    retries0 = program.alloc_retries(device)
    walls = []
    use0 = _usage()
    with contextlib.ExitStack() as stack:
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = stack.enter_context(torch.profiler.profile(activities=acts))
        t0 = time.perf_counter()
        run.setup_s = t0 - t_start
        with run.span("window"):
            while True:
                state.step(run.steps)
                run.steps += 1
                walls.append(time.perf_counter() - t0)
                if walls[-1] >= seconds:
                    break
            _sync(device)
        run.window_s = time.perf_counter() - t0
    use = [round(b - a, 3) for a, b in zip(use0, _usage())]
    run.counters = program.read_counters()
    run.window_peak_bytes = _peak_bytes(cuda, chips)
    run.alloc_retries = program.alloc_retries(device) - retries0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {', '.join(found)}")
    if prof is not None:
        run.trace_summary = tracing.reduce(prof, counted_spans=(state.entry,), devices=chips)
        del prof
    values = {}
    for m in cell_metrics(bench, cell, trace):
        reader = load_module(os.path.join(pb_dir, "metrics", f"{m['name']}.py"),
                             f"portbench_metric_{m['name'].replace('.', '_')}")
        v = reader.read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": max(setup_peak, run.window_peak_bytes)}
    ts = run.trace_summary
    if ts is not None and ts["busy_s"] is not None:
        dev.update(busy_s=ts["busy_s"], window_s=ts["window_s"])
    phases = {k: round(v, 3) for k, v in run.counters.get("host_phase_s", {}).items()}
    print(f"steps {run.steps} window_s {run.window_s} setup_s {run.setup_s} "
          f"window user_s, sys_s, minflt, nvcsw, nivcsw {use} "
          f"host_phase_s {phases} step walls "
          f"{[round(b - a, 4) for a, b in zip([0.0] + walls, walls)][:64]}", file=log)
    # the program's state is freed before the reference runs
    state.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, checked, failed = state.check()
    correct = checked > 0 and all(v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": run.steps, "failed": failed, "metrics": values,
           "device": dev}
    if ts is not None and ts["busy_s"] is not None:
        out["breakdown"] = {"device_ops": ts["device_ops"], "idle_gaps": ts["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {', '.join(found)}")
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=log)
    return out
