"""Build the port's CUDA sources into shared libraries at first use.

Each ``dbcsr_tpu_torch/csrc/*.cu`` file has a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into
``dbcsr_tpu_torch/_build/lib<name>.<hash>.so``, where the hash covers the
source and the flags, so an edited source rebuilds and an unchanged one
is reused.  The library is loaded with ctypes by the kernel's wrapper.
Several sources build in parallel, one ``nvcc`` each (`build_all`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# every source of the port (csrc/): the base stack kernel and the
# crosspack kernel
SOURCES = ("smm_stack.cu", "smm_crosspack.cu")

# seconds each source's nvcc took in this process (0.0 = reused .so),
# and nvcc's compiler output (ptxas registers / shared memory / spills)
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin/nvcc``, then ``PATH``,
    then ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels of dbcsr_tpu_torch are built at first use")


def library_path(source: str) -> str:
    """Content-hashed output path of ``source`` (a file name in csrc/)."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}.{h.hexdigest()[:16]}.so")


def build_all(sources: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source that has no up-to-date library, all nvcc
    processes started together; returns {source: library path}.
    Raises with nvcc's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out: Dict[str, str] = {}
    running: Dict[str, Tuple[subprocess.Popen, str, float]] = {}
    try:
        for src in sources:
            path = out[src] = library_path(src)
            if os.path.exists(path):
                build_seconds.setdefault(src, 0.0)
                continue
            tmp = f"{path}.tmp{os.getpid()}"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running[src] = (proc, tmp, time.perf_counter())
        for src, (proc, tmp, t0) in list(running.items()):
            log, _ = proc.communicate()
            build_seconds[src] = time.perf_counter() - t0
            build_logs[src] = log
            del running[src]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src} (rc {proc.returncode}):\n{log}")
            os.replace(tmp, out[src])
    finally:
        for proc, tmp, _ in running.values():
            proc.kill()
            proc.wait()
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        lib = _loaded[source] = ctypes.CDLL(build_all([source])[source])
    return lib
