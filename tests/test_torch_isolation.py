"""The port stands alone and never lands on the CPU by accident.

* Importing every `dbcsr_tpu_torch` module and `chip_smoke` pulls in
  neither JAX nor any module of the JAX package (checked in a fresh
  interpreter that refuses those imports).
* Entry points raise without CUDA unless the CPU is asked for, and a
  CUDA request never silently runs on the CPU: neither a kernel wrapper
  nor ``mm_driver="host"``, which serves CPU tensors only.
* `chip_smoke.py` exits non-zero and prints no result without CUDA, and
  when it is run alone, away from the repository.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dbcsr_tpu_torch import device as port_device
from dbcsr_tpu_torch.acc import smm as port_smm
from dbcsr_tpu_torch.acc import stack_kernel
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.interop import matrix_from_numpy_state, matrix_to_numpy_state
from dbcsr_tpu_torch.ops.test_methods import make_random_matrix
from dbcsr_tpu_torch.perf.driver import PerfConfig, run_perf
from dbcsr_tpu_torch.tas import TASMatrix
from dbcsr_tpu_torch.tensor import create_tensor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ISOLATION_SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "dbcsr_tpu")

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"the port imported {name}")
        return None

for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]
sys.meta_path.insert(0, Refuse())
import dbcsr_tpu_torch
mods = ["chip_smoke", "dbcsr_tpu_torch"]
for info in pkgutil.walk_packages(dbcsr_tpu_torch.__path__, "dbcsr_tpu_torch."):
    mods.append(info.name)
for m in mods:
    importlib.import_module(m)
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
print(len(mods), "modules:", " ".join(mods))
"""

# modules the sweep must reach: one per layer of the stack path, the
# crosspack kernel's planning, wrapper and tuned table included, and the
# model loops with the operations, digests and residency chain they use,
# the native index engine and the storage-format planner, and the
# integrity plane (faults, breakers, ABFT, events, chain guard), the
# precision planner and the incremental multiply, and the statistics,
# tracer, profile epochs, library lifecycle and knob registry, and the
# distributed engine (grid, ticks, engines, world), and the telemetry,
# health and diagnosis plane with the watchdog, lockcheck and the tuner,
# and the serving plane with its HTTP endpoint, router and fleet
_REQUIRED = {"chip_smoke", "dbcsr_tpu_torch.acc.build", "dbcsr_tpu_torch.acc.crosspack",
             "dbcsr_tpu_torch.acc.crosspack_kernel", "dbcsr_tpu_torch.acc.params",
             "dbcsr_tpu_torch.acc.smm", "dbcsr_tpu_torch.acc.stack_kernel",
             "dbcsr_tpu_torch.mm.multiply", "dbcsr_tpu_torch.obs.costmodel",
             "dbcsr_tpu_torch.perf.driver", "dbcsr_tpu_torch.core.digests",
             "dbcsr_tpu_torch.core.mempool", "dbcsr_tpu_torch.models",
             "dbcsr_tpu_torch.models.purify", "dbcsr_tpu_torch.models.sign",
             "dbcsr_tpu_torch.models.invsqrt", "dbcsr_tpu_torch.ops.operations",
             "dbcsr_tpu_torch.ops.transformations", "dbcsr_tpu_torch.native",
             "dbcsr_tpu_torch.mm.format_planner", "dbcsr_tpu_torch.core.timings",
             "dbcsr_tpu_torch.tas.mm", "dbcsr_tpu_torch.tas.batched",
             "dbcsr_tpu_torch.tensor.contract", "dbcsr_tpu_torch.tensor.types",
             "dbcsr_tpu_torch.tensor.batched", "dbcsr_tpu_torch.acc.abft",
             "dbcsr_tpu_torch.resilience", "dbcsr_tpu_torch.resilience.faults",
             "dbcsr_tpu_torch.resilience.breaker", "dbcsr_tpu_torch.resilience.sites",
             "dbcsr_tpu_torch.obs.metrics", "dbcsr_tpu_torch.obs.events",
             "dbcsr_tpu_torch.obs.flight", "dbcsr_tpu_torch.models.integrity",
             "dbcsr_tpu_torch.acc.precision", "dbcsr_tpu_torch.mm.incremental",
             "dbcsr_tpu_torch.core.kinds", "dbcsr_tpu_torch.core.stats",
             "dbcsr_tpu_torch.core.lib", "dbcsr_tpu_torch.core.knobs",
             "dbcsr_tpu_torch.obs.shard", "dbcsr_tpu_torch.obs.tracer",
             "dbcsr_tpu_torch.obs.profiler", "dbcsr_tpu_torch.acc.bench",
             "dbcsr_tpu_torch.acc.tune", "dbcsr_tpu_torch.ops.csr", "dbcsr_tpu_torch.ops.io",
             "dbcsr_tpu_torch.ops.tests", "dbcsr_tpu_torch.parallel",
             "dbcsr_tpu_torch.parallel.mesh", "dbcsr_tpu_torch.parallel.images",
             "dbcsr_tpu_torch.parallel.overlap", "dbcsr_tpu_torch.parallel.cannon",
             "dbcsr_tpu_torch.parallel.dist_matrix", "dbcsr_tpu_torch.parallel.sparse_dist",
             "dbcsr_tpu_torch.parallel.multihost", "dbcsr_tpu_torch.utils.lockcheck",
             "dbcsr_tpu_torch.resilience.watchdog", "dbcsr_tpu_torch.obs.windows",
             "dbcsr_tpu_torch.obs.timeseries", "dbcsr_tpu_torch.obs.slo",
             "dbcsr_tpu_torch.obs.health", "dbcsr_tpu_torch.obs.attribution",
             "dbcsr_tpu_torch.obs.incidents", "dbcsr_tpu_torch.obs.changepoint",
             "dbcsr_tpu_torch.obs.rca", "dbcsr_tpu_torch.tune", "dbcsr_tpu_torch.tune._env",
             "dbcsr_tpu_torch.tune.store", "dbcsr_tpu_torch.tune.predictor",
             "dbcsr_tpu_torch.tune.miner", "dbcsr_tpu_torch.tune.trials",
             "dbcsr_tpu_torch.tune.service", "dbcsr_tpu_torch.serve",
             "dbcsr_tpu_torch.serve.session", "dbcsr_tpu_torch.serve.queue",
             "dbcsr_tpu_torch.serve.coalesce", "dbcsr_tpu_torch.serve.product_cache",
             "dbcsr_tpu_torch.serve.engine", "dbcsr_tpu_torch.serve.workload",
             "dbcsr_tpu_torch.serve.router", "dbcsr_tpu_torch.serve.fleet",
             "dbcsr_tpu_torch.obs.server"}


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _ISOLATION_SCRIPT], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, _, names = out.stdout.partition("modules:")
    assert int(count) >= 92
    assert _REQUIRED <= set(names.split())


def test_no_port_source_imports_jax_or_the_jax_package():
    """The import sweep sees module-level imports only; a function that
    imports inside its body is caught here, in the source."""
    import re

    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|dbcsr_tpu)(\.|\s|$)")
    bad = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "dbcsr_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    bad += [f"{path}:{i}" for i, line in enumerate(fh, 1) if pat.match(line)]
    assert not bad, bad


_LIGHT_IMPORT_SCRIPT = r"""
import os, sys
import torch
import dbcsr_tpu_torch as dt
from dbcsr_tpu_torch import native
from dbcsr_tpu_torch.acc import build
assert len(dt.__all__) > 80
assert not torch.cuda.is_initialized(), "importing the package initialized CUDA"
assert native._lib is None and native.build_seconds is None, "the index engine was built"
assert not build._loaded and not build.build_seconds, "a CUDA library was built or loaded"
assert "triton" not in sys.modules
print("light")
"""


def test_package_import_builds_nothing_and_touches_no_card():
    """`import dbcsr_tpu_torch` (the whole public surface) starts no CUDA
    context and builds neither the kernels nor the index engine."""
    out = subprocess.run([sys.executable, "-c", _LIGHT_IMPORT_SCRIPT], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "light"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_constructors_raise_without_cuda_unless_cpu_is_asked(no_cuda):
    assert port_device.default_device().type == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        BlockSparseMatrix("A", [5, 13], [23], device=None)
    with pytest.raises(RuntimeError, match="cuda"):
        BlockSparseMatrix("A", [5, 13], [23], device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        make_random_matrix("A", [5], [5], rng=np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="cuda"):
        run_perf(PerfConfig(m=10, n=10, k=10), verbose=False)
    m = BlockSparseMatrix("A", [5, 13], [23], device="cpu")
    assert m.device.type == "cpu"
    state = matrix_to_numpy_state(
        make_random_matrix("A", [5, 13], [23], occupation=1.0,
                           rng=np.random.default_rng(0), device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        matrix_from_numpy_state(state)
    with pytest.raises(RuntimeError, match="cuda"):
        matrix_from_numpy_state(state, "cuda:0")
    for make in (lambda **kw: create_tensor("T", [[2], [3], [4]], **kw),
                 lambda **kw: TASMatrix.create("T", [5, 13], [23], **kw)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
        with pytest.raises(RuntimeError, match="cuda"):
            make(device="cuda")
        t = make(device="cpu")
        assert t.matrix.device.type == "cpu"


def test_serving_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda):
    """`ServeEngine`, `Session`, `Fleet`, the engine an HTTP route serves
    from, and a fleet worker: each asked for the card (by default or by
    name) raises on a host without one, and runs when the CPU is asked
    for."""
    from dbcsr_tpu_torch.serve import ServeEngine, Session
    from dbcsr_tpu_torch.serve import engine as serve_engine
    from dbcsr_tpu_torch.serve.fleet import Fleet, _worker_main

    for make in (lambda **kw: ServeEngine(start=False, **kw),
                 lambda **kw: Session("t", register=False, **kw),
                 lambda **kw: serve_engine.get_engine(start=False, **kw)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
        with pytest.raises(RuntimeError, match="cuda"):
            make(device="cuda")
        assert make(device="cpu").device.type == "cpu"
        serve_engine.shutdown()
    with pytest.raises(RuntimeError, match="cuda"):
        Fleet(n=1)
    with pytest.raises(RuntimeError, match="cuda"):
        Fleet(n=1, device="cuda")
    assert serve_engine.current_engine() is None
    with pytest.raises(RuntimeError, match="cuda"):
        _worker_main("cuda", {"serve_coalesce": False})
    assert serve_engine.current_engine() is None


def test_fleet_worker_asked_for_cuda_fails_to_start(tmp_path):
    """A worker process asked for the card on a host without one exits
    before its engine runs, so it never answers a heartbeat."""
    env = _env(CUDA_VISIBLE_DEVICES="", DBCSR_TPU_TORCH_OBS_PORT="0")
    out = subprocess.run([sys.executable, "-m", "dbcsr_tpu_torch.serve.fleet", "--worker",
                          "--device", "cuda"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "cuda" in out.stderr


def test_set_default_device_cpu_is_explicit(no_cuda):
    try:
        port_device.set_default_device("cpu")
        m = BlockSparseMatrix("A", [5], [5])
        assert m.device.type == "cpu"
    finally:
        port_device.set_default_device("cuda")
    with pytest.raises(RuntimeError):
        BlockSparseMatrix("A", [5], [5])
    with pytest.raises(ValueError):
        port_device.resolve_device("meta")


def test_non_cpu_tensor_never_takes_the_plain_version():
    a = torch.empty((4, 5, 6), dtype=torch.float64, device="meta")
    b = torch.empty((4, 6, 7), dtype=torch.float64, device="meta")
    c = torch.empty((3, 5, 7), dtype=torch.float64, device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    ptr = torch.zeros(2, dtype=torch.int32, device="meta")
    run_c = torch.zeros(1, dtype=torch.int32, device="meta")
    stack_kernel.reset_counts()
    with pytest.raises(ValueError, match="no stack kernel"):
        stack_kernel.smm_stack(c, a, b, idx, idx, ptr, run_c)
    assert stack_kernel.plain_calls == 0 and stack_kernel.launches == 0


def test_host_driver_refuses_a_device_tensor():
    """``mm_driver="host"`` on a tensor off the CPU (a CUDA tensor on the
    card; a meta tensor stands in for it here) raises instead of moving
    the stack to the host."""
    a = torch.empty((4, 5, 6), dtype=torch.float64, device="meta")
    b = torch.empty((4, 6, 7), dtype=torch.float64, device="meta")
    c = torch.empty((3, 5, 7), dtype=torch.float64, device="meta")
    prev = get_config().mm_driver
    try:
        set_config(mm_driver="host")
        with pytest.raises(ValueError, match="CPU tensors only"):
            port_smm.prepare_stack(c, a, b, [0, 1], [0, 1], [0, 2])
    finally:
        set_config(mm_driver=prev)


def test_chip_smoke_refuses_without_cuda():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
