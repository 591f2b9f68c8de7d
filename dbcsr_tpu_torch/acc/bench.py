"""Standalone acc-layer micro-benchmarks.

Counterpart of `dbcsr_tpu/acc/bench.py` (ref `src/acc/acc_bench_smm.c`
and `acc_bench_trans.c`): exercise only the acc contract --
`acc.smm.prepare_stack`/`execute_stack` and `acc.smm.transpose_blocks`
-- with no engine or index machinery around it, validate against a
float64 host oracle (ref `libsmm_acc_benchmark.cpp:60-85`), and report
GFLOP/s and GB/s.  Runs on the card unless ``device="cpu"`` is asked
for (where the kernels run their plain versions).

CLI (positional, ``0`` = default, as the reference drivers take them):

    python -m dbcsr_tpu_torch.acc.bench smm   [nrep] [stack_size] [m] [n] [k] [dtype]
    python -m dbcsr_tpu_torch.acc.bench trans [nrep] [stack_size] [m] [n] [dtype]

dtype is the reference datatype enum (1 = r4, 3 = r8, 9 = bf16;
`acc_libsmm.h:31-36`).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from dbcsr_tpu_torch.core.kinds import dtype_of, host_dtype, name_of
from dbcsr_tpu_torch.device import resolve_device
from dbcsr_tpu_torch.obs import costmodel

# entries of the host oracle's products per chunk (bounds its temporary)
_ORACLE_CHUNK = 1 << 15


def _rand_stack(rng, nblocks_a, nblocks_b, nblocks_c, stack_size):
    ai = rng.integers(0, nblocks_a, stack_size).astype(np.int32)
    bi = rng.integers(0, nblocks_b, stack_size).astype(np.int32)
    ci = np.sort(rng.integers(0, nblocks_c, stack_size)).astype(np.int32)
    return ai, bi, ci


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_kind(device: torch.device) -> str:
    """The card's name, or "cpu"."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def host_oracle(a: torch.Tensor, b: torch.Tensor, ai, bi, ci, nc: int) -> torch.Tensor:
    """``C[ci[s]] += A[ai[s]] @ B[bi[s]]`` in float64 on the host CPU, a
    bounded chunk of entries at a time (the float64 oracle of
    `libsmm_acc_benchmark.cpp:60-85`); ``a`` and ``b`` are float64 CPU
    tensors."""
    want = torch.zeros((nc, a.shape[1], b.shape[2]), dtype=torch.float64)
    ai, bi, ci = (torch.from_numpy(np.asarray(x, np.int64)) for x in (ai, bi, ci))
    for s0 in range(0, len(ai), _ORACLE_CHUNK):
        sl = slice(s0, s0 + _ORACLE_CHUNK)
        want.index_add_(0, ci[sl], torch.bmm(a[ai[sl]], b[bi[sl]]))
    return want


def bench_smm(nrep=5, stack_size=30000, m=23, n=23, k=23, dtype_enum=3,
              out=print, seed=42, device=None) -> dict:
    """Batched-SMM benchmark with host validation; returns a result dict
    with the JAX package's keys, plus ``device_kind``, the least bytes
    (``min_bytes``, `obs.costmodel.stack_min_bytes`) and the kernel the
    plan launches (``launched``)."""
    from dbcsr_tpu_torch.acc.smm import execute_stack, prepare_stack

    dev = resolve_device(device)
    dtype = dtype_of(dtype_enum)
    rng = np.random.default_rng(seed)
    # the reference's sizing: ~stack_size/16 distinct blocks cycle through
    # device memory
    na = nb = max(stack_size // 16, 1)
    nc = max(stack_size // 8, 1)
    hdt = host_dtype(dtype)
    a = torch.from_numpy(rng.standard_normal((na, m, k)).astype(hdt)).to(dev, dtype)
    b = torch.from_numpy(rng.standard_normal((nb, k, n)).astype(hdt)).to(dev, dtype)
    ai, bi, ci = _rand_stack(rng, na, nb, nc, stack_size)
    # the oracle multiplies the values the card holds (bf16 rounded)
    want = host_oracle(a.cpu().double(), b.cpu().double(), ai, bi, ci, nc)

    plan = prepare_stack(torch.zeros((nc, m, n), dtype=dtype, device=dev), a, b, ai, bi, ci)
    c = execute_stack(torch.zeros((nc, m, n), dtype=dtype, device=dev), a, b, plan, 1.0)
    # compare on the device and fetch one scalar
    scale = max(float(want.abs().max()), 1.0)
    max_err = float((c.double() - want.to(dev)).abs().max()) / scale
    del want
    # bf16 stores C at an 8-bit mantissa: even an exact float32 sum
    # rounds to ~4e-3 relative on store
    itemsize = a.element_size()
    tol = 2e-2 if itemsize <= 2 else (1e-3 if itemsize <= 4 else 1e-10)
    ok = max_err < tol

    times = []
    for _ in range(nrep):
        c.zero_()
        _sync(dev)
        t0 = time.perf_counter()
        execute_stack(c, a, b, plan, 1.0)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    best = min(times)
    flops = costmodel.stack_flops(m, n, k, stack_size)
    dname = name_of(dtype)
    # both byte conventions: every entry fetching its A and B block (the
    # JAX package's), and each referenced block read once (the port's)
    nbytes = costmodel.stack_bytes(m, n, k, stack_size, nseg=nc, itemsize=itemsize)
    min_bytes = costmodel.stack_min_bytes(dname, m, n, k, stack_size, plan.n_a, plan.n_b,
                                          plan.nruns)
    variant = ("crosspack_vmem" if plan.resident else "crosspack") \
        if plan.driver == "crosspack" else None
    result = {
        "kernel": f"{m}x{n}x{k}",
        "dtype": dname,
        "stack_size": stack_size,
        "device": str(dev),
        "device_kind": device_kind(dev),
        "gflops": flops / best / 1e9,
        "gbs": nbytes / best / 1e9,
        "bytes": nbytes,
        "min_bytes": min_bytes,
        "min_gbs": min_bytes / best / 1e9,
        "ms": best * 1e3,
        "max_rel_err": max_err,
        "errors": 0 if ok else 1,
        # what the repeats time: launches on a prepared plan
        "timed": "execute",
        "driver": plan.label,
        "variant": variant,
        "launched": plan.kernel,
        "precision": list(plan.precision) if plan.precision else None,
        # the port has no R grouping (a crosspack plan's R is in ``pack``)
        "r_grp": None,
        "pack": list(plan.pack) if plan.pack else None,
        "entries": plan.entries,
        "n_a": plan.n_a,
        "n_b": plan.n_b,
        "nruns": plan.nruns,
    }
    out(f"typename (id={dtype_enum}): {result['dtype']}")
    out(f"device: {result['device']} ({result['device_kind']})")
    out(f"smm {m}x{n}x{k} stack {stack_size}: {result['ms']:.3f} ms "
        f"{result['gflops']:.1f} GFLOP/s {result['gbs']:.1f} GB/s ({plan.kernel})")
    out(f"errors: {result['errors']}")
    return result


def bench_trans(nrep=5, stack_size=30000, m=23, n=23, dtype_enum=3,
                out=print, seed=42, device=None) -> dict:
    """Batched block-transpose benchmark (ref `acc_bench_trans.c`)."""
    from dbcsr_tpu_torch.acc.smm import transpose_blocks

    dev = resolve_device(device)
    dtype = dtype_of(dtype_enum)
    rng = np.random.default_rng(seed)
    nblocks = max(stack_size // 4, 1)
    data = torch.from_numpy(rng.standard_normal((nblocks, m, n)).astype(host_dtype(dtype))
                            ).to(dev, dtype)
    ok = bool(torch.equal(transpose_blocks(data).cpu(), data.cpu().transpose(1, 2)))

    times = []
    for _ in range(nrep):
        _sync(dev)
        t0 = time.perf_counter()
        transpose_blocks(data)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    best = min(times)
    bytes_moved = 2 * data.numel() * data.element_size()
    result = {
        "kernel": f"{m}x{n}",
        "dtype": name_of(dtype),
        "nblocks": nblocks,
        "device": str(dev),
        "device_kind": device_kind(dev),
        "bytes": bytes_moved,
        "gbs": bytes_moved / best / 1e9,
        "ms": best * 1e3,
        "errors": 0 if ok else 1,
    }
    out(f"typename (id={dtype_enum}): {result['dtype']}")
    out(f"device: {result['ms']:.3f} ms {result['gbs']:.1f} GB/s")
    out(f"errors: {result['errors']}")
    return result


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("smm", "trans"):
        print(__doc__)
        return 1
    mode = argv.pop(0)
    defaults = [5, 30000, 23, 23, 23, 3] if mode == "smm" else [5, 30000, 23, 23, 3]
    vals = list(defaults)
    for i, arg in enumerate(argv[: len(defaults)]):
        if int(arg) != 0:
            vals[i] = int(arg)
    res = bench_smm(*vals) if mode == "smm" else bench_trans(*vals)
    return res["errors"]


if __name__ == "__main__":
    sys.exit(main())
