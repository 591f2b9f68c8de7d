"""The stack kernel: its wrapper, its plain PyTorch version, and its
launch count.

Computes, for each run r of a stack sorted by destination block,

    C[run_c[r]] = C[run_c[r]] + alpha * sum_{e in run r} A[a_idx[e]] @ B[b_idx[e]]

in place.  On a CUDA tensor `smm_stack` launches the hand-written kernel
of ``csrc/smm_stack.cu``, its warp path or its tiled path by shape
(`kernel_path`; the tiled path's geometry is `tiled_geometry`, read
from the kernel library; it replaces the Pallas kernel
`dbcsr_tpu/acc/pallas_smm.py:_smm_kernel`, base and kmerge variants); on
a CPU tensor it runs `smm_stack_plain`, the same function as
gather -> `torch.bmm` -> `index_add_` in stack order.  The wrapper never
falls back to the plain version: a CUDA launch that fails raises, and
`acc.smm.execute_stack` counts the failure and fails the stack over.

Besides float64, float32 and bfloat16, the kernel has two groups of
forms that the JAX package computes in XLA, never in Pallas
(`dbcsr_tpu/acc/smm.py:78-135`): complex64/complex128 (complex alpha),
and the demoted compute forms of a ``precision`` spec
(`acc/precision.py`): ("float32", False), ("float32", True),
("bfloat16", False) and ("bfloat16", True) for float64 data, the bf16
pair for float32 data.  Every form takes both paths, each on its own
register tile of the path's one kernel body.  The plain version
computes each form as `_batch_dot` does; `form_units` names the units
each runs on.

`smm_superstack` is the same kernel's fused launch over every span of
one C bin (``csrc/smm_stack.cu``, `smm_superstack_launch`; the JAX
package's fused chain of K1 launches, `dbcsr_tpu/acc/smm.py:_fused_fn`):
`superstack_table` merges the spans' runs into one run per C block, a
list of segments in span order, and the launch walks them so that the
result is bit for bit the spans' launches one after the other: on both
paths the per-span kernel's own body with a segment policy, C updated
at each segment's end as each span's launch updates it.  Its plain version
`smm_superstack_plain` is exactly that sequence of `smm_stack_plain`
calls.  Native real forms only (float64, float32, bfloat16).
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from dbcsr_tpu_torch.acc import build

SOURCE = "smm_stack.cu"

# launches of the CUDA kernel, and calls of the plain version, since the
# last reset (chip_smoke.py reads them around the main path); the
# launches again by form, "<dtype>" or "<dtype>:<compute>[+comp]"
launches = 0
plain_calls = 0
launches_by_form: dict = {}
# launches of the fused kernel (`smm_superstack`), counted apart from K1's
superstack_launches = 0

_DTYPE_CODE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2,
               torch.complex64: 3, torch.complex128: 4}
# the demoted compute forms by precision spec, and the data dtypes each
# takes (the resolver never demotes bf16 or complex data)
_COMPUTE_CODE = {None: 0, ("float32", False): 1, ("float32", True): 2,
                 ("bfloat16", False): 3, ("bfloat16", True): 4}
_COMPUTE_DTYPES = {1: (torch.float64,), 2: (torch.float64,),
                   3: (torch.float64, torch.float32), 4: (torch.float64, torch.float32)}
_COMPUTE_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_lib = None


def reset_counts() -> None:
    global launches, plain_calls, superstack_launches
    launches = 0
    plain_calls = 0
    superstack_launches = 0
    launches_by_form.clear()


def form_name(dtype: torch.dtype, precision=None) -> str:
    """A form's name: the data dtype, and a demoted compute spec."""
    name = str(dtype).replace("torch.", "")
    if precision is None:
        return name
    return f"{name}:{precision[0]}{'+comp' if precision[1] else ''}"


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        lib.smm_stack_launch.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
        ]
        lib.smm_stack_launch.restype = ctypes.c_int
        lib.smm_stack_path.argtypes = [ctypes.c_int] * 4
        lib.smm_stack_path.restype = ctypes.c_int
        lib.smm_stack_attrs.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        lib.smm_stack_attrs.restype = ctypes.c_int
        lib.smm_stack_error_string.argtypes = [ctypes.c_int]
        lib.smm_stack_error_string.restype = ctypes.c_char_p
        ptrs = ctypes.POINTER(ctypes.c_longlong)
        lib.smm_superstack_launch.argtypes = [
            ctypes.c_int, ctypes.c_int, ptrs, ptrs, ptrs, ptrs, ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_void_p,
        ]
        lib.smm_superstack_launch.restype = ctypes.c_int
        lib.smm_superstack_max_spans.argtypes = []
        lib.smm_superstack_max_spans.restype = ctypes.c_int
        ints = ctypes.POINTER(ctypes.c_int)
        lib.smm_superstack_attrs.argtypes = [ctypes.c_int, ctypes.c_int, ints, ctypes.c_int,
                                             ctypes.c_int, ints]
        lib.smm_superstack_attrs.restype = ctypes.c_int
        lib.smm_stack_tiled_geom.argtypes = [ctypes.c_int] * 5 + [ints]
        lib.smm_stack_tiled_geom.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_path(m: int, n: int, k: int, dtype: torch.dtype = torch.float64) -> str:
    """Which hand-written path of ``csrc/smm_stack.cu`` a launch of (m, n, k)
    blocks of ``dtype`` takes, whatever its form: "warp" (one warp per
    run, m, n, k <= 32; complex and demoted forms too) or "tiled"."""
    return "warp" if _kernel_lib().smm_stack_path(_DTYPE_CODE[dtype], m, n, k) == 1 else "tiled"


# the units each form's products run on, on both paths: "dmma" the FP64
# tensor cores, "fp32_fma" the CUDA cores in f32, "bf16_mma" the tensor
# cores with bf16 inputs and f32 sums
_FORM_UNITS = {("float64", None): "dmma", ("float32", None): "fp32_fma",
               ("bfloat16", None): "fp32_fma", ("complex128", None): "dmma",
               ("complex64", None): "fp32_fma",
               ("float64", ("float32", False)): "fp32_fma",
               ("float64", ("float32", True)): "dmma",
               ("float64", ("bfloat16", False)): "bf16_mma",
               ("float64", ("bfloat16", True)): "dmma",
               ("float32", ("bfloat16", False)): "bf16_mma",
               ("float32", ("bfloat16", True)): "bf16_mma"}


def form_units(dtype: torch.dtype, precision=None) -> str:
    """The units a form's products run on, the same on the warp path and
    the tiled path (each form's register tile of either path uses them)."""
    spec = None if precision is None else tuple(precision)
    return _FORM_UNITS[(str(dtype).replace("torch.", ""), spec)]


_ATTRS = ("registers", "local_bytes", "shared_bytes", "warps", "blocks_per_sm")


def _attrs_or_raise(lib, err: int, out, what: str) -> dict:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{lib.smm_stack_error_string(err).decode()}")
    return dict(zip(_ATTRS, out))


def kernel_attrs(m: int, n: int, k: int, dtype: torch.dtype = torch.float64,
                 precision=None) -> dict:
    """The compiled instance a launch of this form and shape runs, as the
    card reports it: registers and local (spilled) bytes a thread, shared
    bytes a block, warps a block, resident blocks an SM."""
    lib = _kernel_lib()
    out = (ctypes.c_int * 5)()
    err = lib.smm_stack_attrs(_DTYPE_CODE[dtype], compute_code(dtype, precision), m, n, k, out)
    return _attrs_or_raise(lib, err, out, f"smm_stack_attrs failed for "
                                          f"{form_name(dtype, precision)} {(m, n, k)}")


def superstack_attrs(m: int, n: int, ks, dtype: torch.dtype = torch.float64) -> dict:
    """The compiled instance a fused launch of an (m, n) bin whose spans
    have the depths ``ks`` runs, as `kernel_attrs` reports it."""
    lib = _kernel_lib()
    out = (ctypes.c_int * 5)()
    span_k = (ctypes.c_int * len(ks))(*ks)
    err = lib.smm_superstack_attrs(_DTYPE_CODE[dtype], len(ks), span_k, m, n, out)
    return _attrs_or_raise(lib, err, out, f"smm_superstack_attrs failed for {dtype} "
                                          f"{(m, n)} k={list(ks)}")


# ------------------------------------------------------------ tiled path
_TILED_KEYS = ("wr", "wc", "rmt", "cnt", "nrc", "ncc", "flat", "ks", "lda", "ldb", "a_area",
               "smem", "bufs")


def tiled_geometry(m: int, n: int, kmax: int, dtype: torch.dtype = torch.float64,
                   precision=None) -> dict:
    """The tiled path's geometry of a launch of one form (``dtype`` data,
    ``precision`` a demoted spec or None) of (m, n) blocks whose entries
    reach depth ``kmax``, as the kernel library's `tiled::geom` computes
    it (csrc/smm_stack.cu): the warps' arrangement ``wr`` x ``wc``, a
    chunk's ``rmt`` row and ``cnt`` column tiles of 8x8, ``nrc`` x ``ncc``
    chunks a C block, whole entries staged ``flat`` or k slices of ``ks``
    (row strides ``lda``, ``ldb``), the A area of a buffer (elements of
    the staged dtype), the shared bytes of the staging buffers, the
    converted planes and the sum, and ``bufs`` staging buffers (2, or 1
    where a converted plane is multiplied while the next entry lands)."""
    lib = _kernel_lib()
    out = (ctypes.c_int * len(_TILED_KEYS))()
    err = lib.smm_stack_tiled_geom(_DTYPE_CODE[dtype], compute_code(dtype, precision), m, n,
                                   kmax, out)
    if err != 0:
        raise RuntimeError(f"smm_stack_tiled_geom failed for {form_name(dtype, precision)} "
                           f"{(m, n, kmax)}: CUDA error {err}")
    return dict(zip(_TILED_KEYS, out))


def compute_code(dtype: torch.dtype, precision) -> int:
    """The kernel's compute form of a ``precision`` spec for ``dtype`` data;
    raises TypeError for a spec the kernel has no form of."""
    code = _COMPUTE_CODE.get(None if precision is None else tuple(precision))
    if code is None or (code and dtype not in _COMPUTE_DTYPES[code]):
        raise TypeError(f"stack kernel has no {precision} form for {dtype}")
    return code


def _check(c, a, b, a_idx, b_idx, run_ptr, run_c) -> None:
    if c.dtype not in _DTYPE_CODE:
        raise TypeError(f"stack kernel takes float64/float32/bfloat16/complex64/complex128, "
                        f"got {c.dtype}")
    if a.dtype != c.dtype or b.dtype != c.dtype:
        raise TypeError(f"operand dtypes {a.dtype}/{b.dtype} differ from C's {c.dtype}")
    if a.dim() != 3 or b.dim() != 3 or c.dim() != 3:
        raise ValueError("A, B and C must be 3-D block arrays")
    m, k = a.shape[1:]
    if b.shape[1] != k or c.shape[1:] != (m, b.shape[2]):
        raise ValueError(f"block shapes A{tuple(a.shape)} B{tuple(b.shape)} "
                         f"C{tuple(c.shape)} do not chain")
    for name, t in (("a_idx", a_idx), ("b_idx", b_idx), ("run_ptr", run_ptr),
                    ("run_c", run_c)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
    if a_idx.numel() != b_idx.numel() or run_ptr.numel() != run_c.numel() + 1:
        raise ValueError("stack arrays have inconsistent lengths")
    for name, t in (("A", a), ("B", b), ("C", c), ("a_idx", a_idx),
                    ("b_idx", b_idx), ("run_ptr", run_ptr), ("run_c", run_c)):
        if t.device != c.device:
            raise ValueError(f"{name} is on {t.device}, C on {c.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def smm_stack(c, a, b, a_idx, b_idx, run_ptr, run_c, alpha=1.0, precision=None):
    """Apply the stack to ``c`` in place and return it: the CUDA kernel on
    a CUDA tensor, `smm_stack_plain` on a CPU tensor.  ``precision`` is a
    demoted compute spec or None (native); ``alpha`` may be complex for
    complex data."""
    global launches
    _check(c, a, b, a_idx, b_idx, run_ptr, run_c)
    compute = compute_code(c.dtype, precision)
    alpha = complex(alpha) if c.dtype.is_complex else float(alpha)
    if c.device.type == "cpu":
        return smm_stack_plain(c, a, b, a_idx, b_idx, run_ptr, run_c, alpha,
                               precision=precision)
    if c.device.type != "cuda":
        raise ValueError(f"no stack kernel for device {c.device}")
    nruns = run_c.numel()
    if nruns == 0:
        return c
    lib = _kernel_lib()
    m, k = a.shape[1:]
    n = b.shape[2]
    stream = torch.cuda.current_stream(c.device).cuda_stream
    with torch.cuda.device(c.device):
        err = lib.smm_stack_launch(
            _DTYPE_CODE[c.dtype], compute, a.data_ptr(), b.data_ptr(), c.data_ptr(),
            a_idx.data_ptr(), b_idx.data_ptr(), run_ptr.data_ptr(),
            run_c.data_ptr(), nruns, m, n, k, complex(alpha).real, complex(alpha).imag,
            stream)
    if err != 0:
        msg = lib.smm_stack_error_string(err).decode()
        raise RuntimeError(f"smm_stack launch failed (m={m}, n={n}, k={k}, "
                           f"{c.dtype}, compute {precision}, nruns={nruns}): "
                           f"CUDA error {err}: {msg}")
    mark_written(c)
    launches += 1
    form = form_name(c.dtype, precision)
    launches_by_form[form] = launches_by_form.get(form, 0) + 1
    return c


def mark_written(c: torch.Tensor) -> None:
    """Bump ``c``'s version counter after a kernel wrote it through its
    raw pointer, as every in-place torch op does: caches keyed on
    `tensor._version` (`mm.multiply._dense_canvas_cached`) then see the
    write."""
    torch.autograd.graph.increment_version(c)


@contextlib.contextmanager
def _full_precision_matmul(device: torch.device):
    """TF32 off for float32 products on the card (it keeps ~3 digits)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def compute_dtype(precision) -> torch.dtype:
    """The compute dtype of a demoted ``precision`` spec."""
    return _COMPUTE_DTYPE[precision[0]]


def split_hi_lo(x: torch.Tensor, cdt: torch.dtype):
    """The two-product operand split: hi = compute(x), lo = compute(x - hi)
    (`dbcsr_tpu/acc/smm.py:_split_hi_lo`)."""
    hi = x.to(cdt)
    return hi, (x - hi.to(x.dtype)).to(cdt)


def batch_dot(a: torch.Tensor, b: torch.Tensor, acc: torch.dtype, precision=None):
    """The block products ``a[s] @ b[s]`` in ``acc`` at the executed
    precision (`dbcsr_tpu/acc/smm.py:_batch_dot`): native; demoted
    uncompensated (the compute-dtype operands multiplied with a float32
    accumulator, widened after); or compensated (hi*hi + (hi*lo + lo*hi)
    of the splits, each product summed in ``acc``)."""
    if precision is None:
        return torch.bmm(a.to(acc), b.to(acc))
    cdt = compute_dtype(precision)
    if not precision[1]:
        # float32 holds a bf16 value exactly: a float32 product of the
        # rounded operands is a bf16 dot with float32 accumulation
        return torch.bmm(a.to(cdt).float(), b.to(cdt).float()).to(acc)
    ah, al = split_hi_lo(a, cdt)
    bh, bl = split_hi_lo(b, cdt)

    def dot(x, y):
        return torch.bmm(x.to(acc), y.to(acc))
    return dot(ah, bh) + (dot(ah, bl) + dot(al, bh))


def smm_stack_plain(c, a, b, a_idx, b_idx, run_ptr, run_c, alpha=1.0,
                    chunk: int = 30000, precision=None):
    """Plain PyTorch version of the kernel's function, in place on ``c``:
    gather ``chunk`` entries at a time, `batch_dot` (`torch.bmm` at the
    executed precision), sum each run's products in stack order with
    `index_add_`, then ``C[run_c] = C[run_c] + alpha * sums``.  bf16
    computes in float32, as the kernel does."""
    global plain_calls
    plain_calls += 1
    nruns = run_c.numel()
    if nruns == 0:
        return c
    acc = torch.float32 if c.dtype == torch.bfloat16 else c.dtype
    m, n = c.shape[1:]
    run_len = (run_ptr[1:] - run_ptr[:-1]).long()
    run_id = torch.repeat_interleave(
        torch.arange(nruns, device=c.device), run_len)
    sums = torch.zeros((nruns, m, n), dtype=acc, device=c.device)
    with _full_precision_matmul(c.device):
        for s0 in range(0, a_idx.numel(), chunk):
            ai = a_idx[s0: s0 + chunk].long()
            bi = b_idx[s0: s0 + chunk].long()
            prod = batch_dot(a[ai], b[bi], acc, precision)
            sums.index_add_(0, run_id[s0: s0 + chunk], prod)
    rc = run_c.long()
    c[rc] = (c[rc].to(acc) + alpha * sums).to(c.dtype)
    return c


# ------------------------------------------------------------ superstack
# spans one fused launch takes (MAX_SPANS of csrc/smm_stack.cu)
SUPERSTACK_MAX_SPANS = 32
_SUPERSTACK_DTYPES = (torch.float64, torch.float32, torch.bfloat16)


def superstack_table(run_ptrs, run_cs, device) -> tuple:
    """The merged run table of one C bin from its spans' runs (host int
    arrays, span order): one run per C block, each a list of segments in
    span order, segment j the entries ``seg_beg[j]..seg_end[j]`` of span
    ``seg_span[j]``'s stack.  Returns the int32 device arrays
    (seg_span, seg_beg, seg_end, run_ptr, run_c)."""
    seg_c = np.concatenate([np.asarray(rc, np.int64) for rc in run_cs])
    seg_span = np.concatenate([np.full(len(rc), s, np.int64) for s, rc in enumerate(run_cs)])
    seg_beg = np.concatenate([np.asarray(rp[:-1], np.int64) for rp in run_ptrs])
    seg_end = np.concatenate([np.asarray(rp[1:], np.int64) for rp in run_ptrs])
    order = np.lexsort((seg_span, seg_c))  # by C block, then span order
    run_c, counts = np.unique(seg_c[order], return_counts=True)
    run_ptr = np.concatenate([[0], np.cumsum(counts)])

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)
    return (up(seg_span[order]), up(seg_beg[order]), up(seg_end[order]), up(run_ptr),
            up(run_c))


def smm_superstack(c, spans, table, alpha=1.0):
    """Apply every span of one C bin to ``c`` in place, in span order, and
    return it: the fused CUDA launch on a CUDA tensor, `smm_superstack_plain`
    on a CPU tensor.  ``spans`` holds each span's (A bin, B bin, a_idx,
    b_idx, run_ptr, run_c) (the stack arrays of its plan), ``table`` the
    bin's `superstack_table` on ``c``'s device."""
    global superstack_launches
    if c.dtype not in _SUPERSTACK_DTYPES:
        raise TypeError(f"the fused stack kernel takes float64/float32/bfloat16, got {c.dtype}")
    if not 1 <= len(spans) <= SUPERSTACK_MAX_SPANS:
        raise ValueError(f"a fused launch takes 1 to {SUPERSTACK_MAX_SPANS} spans, "
                         f"got {len(spans)}")
    for sp in spans:
        _check(c, *sp)
    for name, t in zip(("seg_span", "seg_beg", "seg_end", "run_ptr", "run_c"), table):
        if t.dtype != torch.int32 or t.dim() != 1 or t.device != c.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor on {c.device}")
    alpha = float(alpha)
    if c.device.type == "cpu":
        return smm_superstack_plain(c, spans, alpha)
    if c.device.type != "cuda":
        raise ValueError(f"no stack kernel for device {c.device}")
    nruns = table[4].numel()
    if nruns == 0:
        return c
    lib = _kernel_lib()
    m, n = c.shape[1:]

    def host(vals, ctype):
        return (ctype * len(vals))(*vals)
    span_a = host([sp[0].data_ptr() for sp in spans], ctypes.c_longlong)
    span_b = host([sp[1].data_ptr() for sp in spans], ctypes.c_longlong)
    span_ai = host([sp[2].data_ptr() for sp in spans], ctypes.c_longlong)
    span_bi = host([sp[3].data_ptr() for sp in spans], ctypes.c_longlong)
    span_k = host([sp[0].shape[2] for sp in spans], ctypes.c_int)
    stream = torch.cuda.current_stream(c.device).cuda_stream
    with torch.cuda.device(c.device):
        err = lib.smm_superstack_launch(
            _DTYPE_CODE[c.dtype], len(spans), span_a, span_b, span_ai, span_bi, span_k,
            c.data_ptr(), *(t.data_ptr() for t in table), nruns, m, n, alpha, stream)
    if err != 0:
        msg = lib.smm_stack_error_string(err).decode()
        raise RuntimeError(f"smm_superstack launch failed (m={m}, n={n}, "
                           f"k={[sp[0].shape[2] for sp in spans]}, {c.dtype}, "
                           f"nruns={nruns}): CUDA error {err}: {msg}")
    mark_written(c)
    superstack_launches += 1
    return c


def smm_superstack_plain(c, spans, alpha=1.0, chunk: int = 30000):
    """Plain PyTorch version of the fused launch: `smm_stack_plain` of
    each span, in span order, in place on ``c``."""
    for a, b, a_idx, b_idx, run_ptr, run_c in spans:
        smm_stack_plain(c, a, b, a_idx, b_idx, run_ptr, run_c, alpha, chunk=chunk)
    return c
