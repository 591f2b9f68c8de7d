"""The multiply's host index engine and the host stack driver: C++ with
OpenMP, bound with ctypes.

Counterpart of `dbcsr_tpu/native/__init__.py`, with its two multiply
entry points, `symbolic_product` (every (i, k, j) triple of op(A)·op(B)
with the norm filter, the symmetric-C skip and the block limits) and
`group_sort_stacks` (the stack order by (group, C slot, A entry)), its
CSR conversion's `coo_fill_blocks` (element values into block buffers,
`ops/csr.py:matrix_from_csr`), and `host_smm`, the native stack driver (``host_smm.cpp``) that
``mm_driver="host"`` and the failover chain run on CPU tensors.

``index_engine.cpp`` and ``host_smm.cpp`` are compiled together at
first use with ``g++ -O3 -march=native -fopenmp -fPIC -shared`` into
``dbcsr_tpu_torch/_build/libdbcsr_index.<hash>.so``; the hash covers the
sources, the flags and the CPU's feature flags (``-march=native`` code
must not run on another CPU), so an edited source or another host
rebuilds.  The compiler writes a file of its own name and the result is
renamed into place, so processes that build at once never load half a
library.

There is no quiet fallback: a failed build or load raises
`acc.build.BuildError`, which the failover chain never takes up.  The
multiply's and the CSR conversion's NumPy paths run only when the
caller asks for them with ``DBCSR_TPU_TORCH_NATIVE=0`` (`enabled`), and
`mm.multiply.read_totals` counts which engine ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.acc.build import BuildError

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_DIR, f) for f in ("index_engine.cpp", "host_smm.cpp"))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")
FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds g++ took in this process (0.0: an existing library was reused)
build_seconds: Optional[float] = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


def enabled() -> bool:
    """Whether the multiply uses this engine: on unless
    ``DBCSR_TPU_TORCH_NATIVE`` is "0"/"false"/"no" (read at every call)."""
    return os.environ.get("DBCSR_TPU_TORCH_NATIVE", "1") not in ("0", "false", "no")


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return b"generic"


def library_path() -> str:
    """Content-hashed path of the library for these sources, these flags
    and this CPU."""
    h = hashlib.sha256()
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    h.update(_cpu_flags())
    return os.path.join(BUILD_DIR, f"libdbcsr_index.{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the engine unless its library exists; returns its path.
    Raises with the compiler's output when g++ is missing or fails."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        if build_seconds is None:
            build_seconds = 0.0
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise BuildError("g++ not found: the host index engine of dbcsr_tpu_torch is "
                         "built at first use (DBCSR_TPU_TORCH_NATIVE=0 selects the "
                         "NumPy path)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    try:
        out = subprocess.run([cxx, *FLAGS, *SOURCES, "-o", tmp], capture_output=True,
                             text=True, timeout=300)
        if out.returncode != 0:
            raise BuildError(f"g++ failed for {' '.join(SOURCES)} (rc {out.returncode}):\n"
                             f"{out.stdout}{out.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return path


def get_lib() -> ctypes.CDLL:
    """The loaded engine, built first if needed; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(build())
            except OSError as exc:
                raise BuildError(f"loading the native library failed: {exc}") from exc
            lib.dbcsr_symbolic_product.restype = ctypes.c_int64
            lib.dbcsr_symbolic_product.argtypes = [
                _I64P, ctypes.c_int64, _I32P, _I64P, _I32P,
                _F32P, _F32P, _F32P, ctypes.c_int32,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, _I64P, _I64P, _I64P, _I64P,
            ]
            lib.dbcsr_group_sort_stacks.restype = None
            lib.dbcsr_group_sort_stacks.argtypes = [
                ctypes.c_int64, _I64P, ctypes.c_int64, _I32P, _I64P, _I64P, _I64P,
            ]
            lib.dbcsr_host_smm.restype = ctypes.c_int32
            lib.dbcsr_host_smm.argtypes = [
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                _I32P, _I32P, _I32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ]
            lib.dbcsr_coo_fill_blocks.restype = None
            lib.dbcsr_coo_fill_blocks.argtypes = [
                ctypes.c_int64, _I64P, _I64P, _I64P, ctypes.c_void_p, ctypes.c_int64,
                _I64P, _I64P, ctypes.c_void_p,
            ]
            lib.dbcsr_native_version.restype = ctypes.c_int32
            lib.dbcsr_native_version.argtypes = []
            _lib = lib
        return _lib


def _ptr(a: Optional[np.ndarray], typ):
    return a.ctypes.data_as(ctypes.POINTER(typ)) if a is not None else None


def symbolic_product(a_row_ptr, a_cols, b_row_ptr, b_cols,
                     a_norms2=None, b_norms2=None, row_eps2=None,
                     sym_c: bool = False, limits=(None,) * 6):
    """The candidate triples as (i, j, a_ent, b_ent) int64 arrays, in the
    order of the NumPy path.  ``a_cols``/``b_cols`` are the block column
    of each A/B entry; the norm filter is on when all three norm arrays
    are given; ``limits`` are the inclusive block limits (first_row,
    last_row, first_col, last_col, first_k, last_k), None for open."""
    lib = get_lib()
    a_row_ptr = np.ascontiguousarray(a_row_ptr, np.int64)
    b_row_ptr = np.ascontiguousarray(b_row_ptr, np.int64)
    a_cols = np.ascontiguousarray(a_cols, np.int32)
    b_cols = np.ascontiguousarray(b_cols, np.int32)
    nrows = len(a_row_ptr) - 1
    if len(a_cols) != a_row_ptr[-1] or len(b_cols) != b_row_ptr[-1]:
        raise ValueError("row pointers and column arrays disagree")
    if len(a_cols) and not (0 <= a_cols.min() and a_cols.max() < len(b_row_ptr) - 1):
        raise ValueError("A's block columns fall outside B's block rows")
    norms = [None if x is None else np.ascontiguousarray(x, np.float32)
             for x in (a_norms2, b_norms2, row_eps2)]
    if any(x is None for x in norms):
        norms = [None, None, None]
    elif (len(norms[0]), len(norms[1]), len(norms[2])) != (len(a_cols), len(b_cols), nrows):
        raise ValueError("norm arrays do not match the entries and rows")
    lim = [-1 if v is None else int(v) for v in limits]
    args = (_ptr(a_row_ptr, ctypes.c_int64), nrows, _ptr(a_cols, ctypes.c_int32),
            _ptr(b_row_ptr, ctypes.c_int64), _ptr(b_cols, ctypes.c_int32),
            _ptr(norms[0], ctypes.c_float), _ptr(norms[1], ctypes.c_float),
            _ptr(norms[2], ctypes.c_float), int(bool(sym_c)), *lim)
    n = lib.dbcsr_symbolic_product(*args, 0, None, None, None, None)
    out = [np.empty(n, np.int64) for _ in range(4)]
    wrote = lib.dbcsr_symbolic_product(*args, n, *(_ptr(x, ctypes.c_int64) for x in out))
    if wrote != n:
        raise RuntimeError(f"symbolic product wrote {wrote} of {n} candidates")
    return tuple(out)


def group_sort_stacks(group, ngroups: int, c_slot, a_ent):
    """The permutation sorting the entries by (group, c_slot, a_ent) and
    the ``ngroups`` + 1 group boundaries."""
    lib = get_lib()
    group = np.ascontiguousarray(group, np.int64)
    c_slot = np.ascontiguousarray(c_slot, np.int32)
    a_ent = np.ascontiguousarray(a_ent, np.int64)
    n = len(group)
    if len(c_slot) != n or len(a_ent) != n:
        raise ValueError("sort keys differ in length")
    if n and not (0 <= group.min() and group.max() < ngroups):
        raise ValueError("group ids outside [0, ngroups)")
    order = np.empty(n, np.int64)
    bounds = np.empty(int(ngroups) + 1, np.int64)
    lib.dbcsr_group_sort_stacks(n, _ptr(group, ctypes.c_int64), int(ngroups),
                                _ptr(c_slot, ctypes.c_int32), _ptr(a_ent, ctypes.c_int64),
                                _ptr(order, ctypes.c_int64), _ptr(bounds, ctypes.c_int64))
    return order, bounds


def coo_fill_blocks(blk_of_entry, local_row, local_col, values: np.ndarray,
                    blk_buf_offset, blk_ncols, out_flat: np.ndarray) -> None:
    """``out_flat[blk_buf_offset[b] + r * blk_ncols[b] + c] = v`` for every
    element (block b, local row r, local column c, value v), in order:
    a duplicate element's last value wins.  ``values`` and ``out_flat``
    are host arrays of one dtype; the indices are checked against
    ``out_flat`` before the native loop writes through its pointer."""
    lib = get_lib()
    values = np.ascontiguousarray(values)
    if not out_flat.flags.c_contiguous or out_flat.dtype != values.dtype:
        raise ValueError("out_flat must be a contiguous array of the values' dtype")
    blk = np.ascontiguousarray(blk_of_entry, np.int64)
    lr = np.ascontiguousarray(local_row, np.int64)
    lc = np.ascontiguousarray(local_col, np.int64)
    off = np.ascontiguousarray(blk_buf_offset, np.int64)
    ncols = np.ascontiguousarray(blk_ncols, np.int64)
    nnz = len(values)
    if not (len(blk) == len(lr) == len(lc) == nnz) or len(off) != len(ncols):
        raise ValueError("COO arrays differ in length")
    if nnz:
        if blk.min() < 0 or blk.max() >= len(off):
            raise IndexError("block index out of range")
        pos = off[blk] + lr * ncols[blk] + lc
        if lr.min() < 0 or lc.min() < 0 or np.any(lc >= ncols[blk]) \
                or pos.min() < 0 or pos.max() >= out_flat.size:
            raise IndexError("element position out of the block buffers")
    lib.dbcsr_coo_fill_blocks(nnz, _ptr(blk, ctypes.c_int64), _ptr(lr, ctypes.c_int64),
                              _ptr(lc, ctypes.c_int64), values.ctypes.data_as(ctypes.c_void_p),
                              values.dtype.itemsize, _ptr(off, ctypes.c_int64),
                              _ptr(ncols, ctypes.c_int64),
                              out_flat.ctypes.data_as(ctypes.c_void_p))


# the reference's datatype codes the host driver takes (r4, r8, c4, c8)
_HOST_DTYPE_CODE = {torch.float32: 1, torch.float64: 3, torch.complex64: 5,
                    torch.complex128: 7}


def host_smm_supports(dtype: torch.dtype) -> bool:
    """Whether `host_smm` takes this dtype (bf16 it does not)."""
    return dtype in _HOST_DTYPE_CODE


def host_smm(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             ai: np.ndarray, bi: np.ndarray, ci: np.ndarray, alpha) -> torch.Tensor:
    """``C[ci[s]] += alpha * A[ai[s]] @ B[bi[s]]`` over a stack sorted by
    ``ci``, in place on ``c``, by the native host driver (ref
    `dbcsr_mm_hostdrv.F:90`).  The block arrays must be contiguous CPU
    tensors of one dtype (float32, float64, complex64 or complex128;
    ``alpha`` may be complex for a complex one); returns ``c``."""
    for name, t in (("A", a), ("B", b), ("C", c)):
        if t.device.type != "cpu":
            raise ValueError(f"host_smm serves CPU tensors only; {name} is on {t.device}")
        if not t.is_contiguous() or t.dim() != 3:
            raise ValueError(f"host_smm needs contiguous 3-D block arrays; {name} is not")
    if not (a.dtype == b.dtype == c.dtype) or not host_smm_supports(c.dtype):
        raise TypeError(f"host_smm takes float32/float64/complex blocks of one dtype, got "
                        f"{a.dtype}/{b.dtype}/{c.dtype}")
    m, k = a.shape[1:]
    n = b.shape[2]
    if b.shape[1] != k or tuple(c.shape[1:]) != (m, n):
        raise ValueError(f"block shapes A{tuple(a.shape)} B{tuple(b.shape)} "
                         f"C{tuple(c.shape)} do not chain")
    ai, bi, ci = (np.ascontiguousarray(x, np.int32) for x in (ai, bi, ci))
    s = len(ai)
    if len(bi) != s or len(ci) != s:
        raise ValueError("a_idx/b_idx/c_idx lengths differ")
    if s == 0:
        return c
    for name, idx, bound in (("a_idx", ai, a.shape[0]), ("b_idx", bi, b.shape[0]),
                             ("c_idx", ci, c.shape[0])):
        if idx.min() < 0 or idx.max() >= bound:
            raise IndexError(f"{name} out of range [0, {bound})")
    if np.any(np.diff(ci) < 0):
        raise ValueError("stack must be sorted by c_idx")
    rc = get_lib().dbcsr_host_smm(
        _HOST_DTYPE_CODE[c.dtype], c.data_ptr(), a.data_ptr(), b.data_ptr(),
        _ptr(ai, ctypes.c_int32), _ptr(bi, ctypes.c_int32), _ptr(ci, ctypes.c_int32),
        s, m, n, k, complex(alpha).real, complex(alpha).imag)
    if rc != 0:
        raise RuntimeError(f"dbcsr_host_smm refused dtype {c.dtype} (rc {rc})")
    torch.autograd.graph.increment_version(c)  # written through its raw pointer
    return c
