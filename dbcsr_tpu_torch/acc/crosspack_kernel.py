"""The crosspack stack kernel: its wrapper, its plain PyTorch version,
and its launch counts.

Computes the stack kernel's function,

    C[run_c[r]] = C[run_c[r]] + alpha * sum_{e in run r} A[a_idx[e]] @ B[b_idx[e]]

for every run r, walking the runs in packs of P (`acc/crosspack.py`
builds the layout).  On a CUDA tensor `smm_crosspack` launches the
hand-written kernel of ``csrc/smm_crosspack.cu`` (its warp path or its
tiled path by shape, `kernel_path`): the plain launch
replaces `dbcsr_tpu/acc/pallas_smm.py:_crosspack_kernel` (K3) and the
resident launch, which keeps one operand bin in persisting L2, replaces
`_crosspack_vmem_kernel` (K4).  On a CPU tensor it runs
`smm_crosspack_plain`, the same function over the same pack layout.
The wrapper never falls back to the plain version or to the base
kernel: a CUDA launch that fails raises, and `acc.smm.execute_stack`
counts the failure, demotes the shape and fails the stack over.
"""

from __future__ import annotations

import ctypes

import torch

from dbcsr_tpu_torch.acc import build
from dbcsr_tpu_torch.acc.stack_kernel import _DTYPE_CODE, _full_precision_matmul, mark_written

SOURCE = "smm_crosspack.cu"

# the kernel's limits on a pack (csrc/smm_crosspack.cu: MAX_P, and MAXJ
# outputs for each of at most MAX_THREADS threads of the tiled path)
MAX_P = 128
MAX_PACK_OUTPUTS = 8 * 1024

# launches of the kernel (plain and resident) and calls of the plain
# version since the last reset (chip_smoke.py reads them around the
# main path)
launches_cross = 0
launches_resident = 0
plain_calls = 0

_lib = None


def reset_counts() -> None:
    global launches_cross, launches_resident, plain_calls
    launches_cross = 0
    launches_resident = 0
    plain_calls = 0


_LAUNCH_ARGS = [
    ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_double,
]


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        lib.smm_crosspack_launch.argtypes = _LAUNCH_ARGS + [ctypes.c_void_p]
        lib.smm_crosspack_launch.restype = ctypes.c_int
        lib.smm_crosspack_resident_launch.argtypes = _LAUNCH_ARGS + [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        lib.smm_crosspack_resident_launch.restype = ctypes.c_int
        lib.smm_crosspack_path.argtypes = [ctypes.c_int] * 6
        lib.smm_crosspack_path.restype = ctypes.c_int
        lib.smm_crosspack_persisting_l2_max.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        lib.smm_crosspack_persisting_l2_max.restype = ctypes.c_int
        lib.smm_crosspack_error_string.argtypes = [ctypes.c_int]
        lib.smm_crosspack_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_path(dtype: torch.dtype, pack, m: int, n: int, k: int) -> str:
    """Which hand-written path of ``csrc/smm_crosspack.cu`` a launch of
    this pack takes: "warp" (one warp per run), "tiled", or "none" when
    the launch would be refused."""
    code = _kernel_lib().smm_crosspack_path(_DTYPE_CODE[dtype], pack[0], pack[1], m, n, k)
    return {1: "warp", 0: "tiled"}.get(code, "none")


def persisting_l2_bytes(device) -> int:
    """The card's persisting-L2 limit (``cudaDevAttrMaxPersistingL2CacheSize``)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no persisting L2 on device {dev}")
    lib = _kernel_lib()
    out = ctypes.c_longlong(0)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = lib.smm_crosspack_persisting_l2_max(index, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"reading the persisting-L2 limit of {dev} failed: CUDA "
                           f"error {err}: {lib.smm_crosspack_error_string(err).decode()}")
    return int(out.value)


def _check(c, a, b, a_idx, b_idx, run_ptr, run_c, pack_runs, pack) -> None:
    if c.dtype not in _DTYPE_CODE:
        raise TypeError(f"crosspack kernel takes float64/float32/bfloat16, got {c.dtype}")
    if a.dtype != c.dtype or b.dtype != c.dtype:
        raise TypeError(f"operand dtypes {a.dtype}/{b.dtype} differ from C's {c.dtype}")
    if a.dim() != 3 or b.dim() != 3 or c.dim() != 3:
        raise ValueError("A, B and C must be 3-D block arrays")
    m, k = a.shape[1:]
    n = b.shape[2]
    if b.shape[1] != k or c.shape[1:] != (m, n):
        raise ValueError(f"block shapes A{tuple(a.shape)} B{tuple(b.shape)} "
                         f"C{tuple(c.shape)} do not chain")
    P, R = pack
    if not 2 <= P <= MAX_P or R < 1:
        raise ValueError(f"pack {tuple(pack)}: need 2 <= P <= {MAX_P} and R >= 1")
    if P * m * n > MAX_PACK_OUTPUTS:
        raise ValueError(f"pack {tuple(pack)} of ({m}, {n}) blocks holds {P * m * n} "
                         f"outputs, more than a thread block's {MAX_PACK_OUTPUTS}")
    for name, t in (("a_idx", a_idx), ("b_idx", b_idx), ("run_ptr", run_ptr),
                    ("run_c", run_c), ("pack_runs", pack_runs)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
    if (a_idx.numel() != b_idx.numel() or run_ptr.numel() != run_c.numel() + 1
            or pack_runs.numel() % P):
        raise ValueError("stack arrays have inconsistent lengths")
    for name, t in (("A", a), ("B", b), ("C", c), ("a_idx", a_idx),
                    ("b_idx", b_idx), ("run_ptr", run_ptr), ("run_c", run_c),
                    ("pack_runs", pack_runs)):
        if t.device != c.device:
            raise ValueError(f"{name} is on {t.device}, C on {c.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def smm_crosspack(c, a, b, a_idx, b_idx, run_ptr, run_c, pack_runs, pack,
                  alpha=1.0, resident=False, window="a"):
    """Apply the stack to ``c`` in place and return it: on a CUDA tensor
    the crosspack kernel (``resident=True``: the launch that keeps the
    operand bin ``window``, "a" or "b", in persisting L2), on a CPU
    tensor `smm_crosspack_plain`."""
    global launches_cross, launches_resident
    _check(c, a, b, a_idx, b_idx, run_ptr, run_c, pack_runs, pack)
    if c.device.type == "cpu":
        return smm_crosspack_plain(c, a, b, a_idx, b_idx, run_ptr, run_c,
                                   pack_runs, pack, alpha)
    if c.device.type != "cuda":
        raise ValueError(f"no crosspack kernel for device {c.device}")
    P, R = pack
    npacks = pack_runs.numel() // P
    if npacks == 0:
        return c
    lib = _kernel_lib()
    m, k = a.shape[1:]
    n = b.shape[2]
    args = (_DTYPE_CODE[c.dtype], a.data_ptr(), b.data_ptr(), c.data_ptr(),
            a_idx.data_ptr(), b_idx.data_ptr(), run_ptr.data_ptr(),
            run_c.data_ptr(), pack_runs.data_ptr(), npacks, P, R, m, n, k,
            float(alpha))
    stream = torch.cuda.current_stream(c.device).cuda_stream
    with torch.cuda.device(c.device):
        if resident:
            if window not in ("a", "b"):
                raise ValueError(f"window must be 'a' or 'b', got {window!r}")
            win = a if window == "a" else b
            err = lib.smm_crosspack_resident_launch(
                *args, win.data_ptr(), win.numel() * win.element_size(), stream)
        else:
            err = lib.smm_crosspack_launch(*args, stream)
    if err != 0:
        msg = lib.smm_crosspack_error_string(err).decode()
        raise RuntimeError(
            f"smm_crosspack{'_resident' if resident else ''} launch failed "
            f"(m={m}, n={n}, k={k}, {c.dtype}, pack={tuple(pack)}, "
            f"npacks={npacks}): CUDA error {err}: {msg}")
    mark_written(c)
    if resident:
        launches_resident += 1
    else:
        launches_cross += 1
    return c


def smm_crosspack_plain(c, a, b, a_idx, b_idx, run_ptr, run_c, pack_runs, pack,
                        alpha=1.0, chunk: int = 30000):
    """Plain PyTorch version over the same pack layout, in place on
    ``c``: for each pack slot p, gather the entries of the runs in slot
    p of every pack (``chunk`` at a time), `torch.bmm`, sum each run's
    products in stack order with `index_add_`, then
    ``C[run_c] = C[run_c] + alpha * sums``.  A run the layout drops is
    never added and a run it holds twice is added twice, so a dealing
    fault shows here as it would on the card.  bf16 computes in float32,
    as the kernel does."""
    global plain_calls
    plain_calls += 1
    P = pack[0]
    acc = torch.float32 if c.dtype == torch.bfloat16 else c.dtype
    m, n = c.shape[1:]
    dev = c.device
    slots = pack_runs.view(-1, P).long()
    run_len = (run_ptr[1:] - run_ptr[:-1]).long()
    with _full_precision_matmul(dev):
        for p in range(P):
            runs_p = slots[:, p]
            runs_p = runs_p[runs_p >= 0]
            if runs_p.numel() == 0:
                continue
            lens = run_len[runs_p]
            local = torch.repeat_interleave(torch.arange(runs_p.numel(), device=dev), lens)
            first = torch.repeat_interleave(run_ptr[runs_p].long() - (torch.cumsum(lens, 0) - lens),
                                            lens)
            ent = first + torch.arange(local.numel(), device=dev)
            sums = torch.zeros((runs_p.numel(), m, n), dtype=acc, device=dev)
            for s0 in range(0, ent.numel(), chunk):
                e = ent[s0: s0 + chunk]
                prod = torch.bmm(a[a_idx[e].long()].to(acc), b[b_idx[e].long()].to(acc))
                sums.index_add_(0, local[s0: s0 + chunk], prod)
            rc = run_c[runs_p].long()
            c[rc] = (c[rc].to(acc) + alpha * sums).to(c.dtype)
    return c
