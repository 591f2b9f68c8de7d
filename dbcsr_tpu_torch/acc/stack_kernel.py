"""The stack kernel: its wrapper, its plain PyTorch version, and its
launch count.

Computes, for each run r of a stack sorted by destination block,

    C[run_c[r]] = C[run_c[r]] + alpha * sum_{e in run r} A[a_idx[e]] @ B[b_idx[e]]

in place.  On a CUDA tensor `smm_stack` launches the hand-written kernel
of ``csrc/smm_stack.cu``, its warp path or its tiled path by shape
(`kernel_path`; it replaces the Pallas kernel
`dbcsr_tpu/acc/pallas_smm.py:_smm_kernel`, base and kmerge variants); on
a CPU tensor it runs `smm_stack_plain`, the same function as
gather -> `torch.bmm` -> `index_add_` in stack order.  The wrapper never
falls back to the plain version: a CUDA launch that fails raises, and
`acc.smm.execute_stack` counts the failure and fails the stack over.

Besides float64, float32 and bfloat16, the kernel has two groups of
forms that the JAX package computes in XLA, never in Pallas
(`dbcsr_tpu/acc/smm.py:78-135`): complex64/complex128 (the tiled path,
complex alpha), and the demoted compute forms of a ``precision`` spec
(`acc/precision.py`): ("float32", False), ("float32", True),
("bfloat16", False) and ("bfloat16", True) for float64 data, the bf16
pair for float32 data, on both paths.  The plain version computes each
form as `_batch_dot` does.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from dbcsr_tpu_torch.acc import build

SOURCE = "smm_stack.cu"

# launches of the CUDA kernel, and calls of the plain version, since the
# last reset (chip_smoke.py reads them around the main path); the
# launches again by form, "<dtype>" or "<dtype>:<compute>[+comp]"
launches = 0
plain_calls = 0
launches_by_form: dict = {}

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
    global launches, plain_calls
    launches = 0
    plain_calls = 0
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
        lib.smm_stack_error_string.argtypes = [ctypes.c_int]
        lib.smm_stack_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_path(m: int, n: int, k: int, dtype: torch.dtype = torch.float64) -> str:
    """Which hand-written path of ``csrc/smm_stack.cu`` a launch of (m, n, k)
    blocks of ``dtype`` takes: "warp" (one warp per run, m, n, k <= 32,
    real dtypes) or "tiled" (complex always)."""
    return "warp" if _kernel_lib().smm_stack_path(_DTYPE_CODE[dtype], m, n, k) == 1 else "tiled"


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
