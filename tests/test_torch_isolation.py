"""The port stands alone and never lands on the CPU by accident.

* Importing every `dbcsr_tpu_torch` module and `chip_smoke` pulls in
  neither JAX nor any module of the JAX package (checked in a fresh
  interpreter that refuses those imports).
* Entry points raise without CUDA unless the CPU is asked for, and a
  CUDA request never silently runs on the CPU.
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
from dbcsr_tpu_torch.acc import stack_kernel
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.interop import matrix_from_numpy_state, matrix_to_numpy_state
from dbcsr_tpu_torch.ops.test_methods import make_random_matrix
from dbcsr_tpu_torch.perf.driver import PerfConfig, run_perf

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
# crosspack kernel's planning, wrapper and tuned table included
_REQUIRED = {"chip_smoke", "dbcsr_tpu_torch.acc.build", "dbcsr_tpu_torch.acc.crosspack",
             "dbcsr_tpu_torch.acc.crosspack_kernel", "dbcsr_tpu_torch.acc.params",
             "dbcsr_tpu_torch.acc.smm", "dbcsr_tpu_torch.acc.stack_kernel",
             "dbcsr_tpu_torch.mm.multiply", "dbcsr_tpu_torch.obs.costmodel",
             "dbcsr_tpu_torch.perf.driver"}


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _ISOLATION_SCRIPT], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, _, names = out.stdout.partition("modules:")
    assert int(count) >= 18
    assert _REQUIRED <= set(names.split())


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
