"""Cost model and tolerances: the subset of `dbcsr_tpu/obs/costmodel.py`
the stack path uses (its own copy: the port imports nothing of the JAX
package).
"""

from __future__ import annotations

# machine epsilon of the accumulation dtype (bf16 accumulates in f32)
_ACC_EPS = {
    "float64": 2.220446049250313e-16,
    "float32": 1.1920929e-07,
    "bfloat16": 1.1920929e-07,
}
# machine epsilon of each dtype's own representation (input rounding)
_COMPUTE_EPS = {
    "float64": 2.220446049250313e-16,
    "float32": 1.1920929e-07,
    "bfloat16": 2.0 ** -8,
}


def stack_bytes(m: int, n: int, k: int, entries: int, *,
                nseg: int | None = None, itemsize: int = 8) -> int:
    """Modeled traffic of one stack when every entry fetches its A and B
    block and each of ``nseg`` C blocks is read and written once (the
    JAX package's roofline convention)."""
    if nseg is None:
        nseg = entries
    return itemsize * (entries * (m * k + k * n) + 2 * nseg * m * n)


def kernel_validation_tolerance(dtype: str, k: int, depth: int) -> float:
    """Relative tolerance of a kernel-vs-oracle elementwise-max check:
    an accumulation term ~eps_acc*sqrt((k+1)*(depth+1)) for a k-deep dot
    summed ``depth`` deep, plus an input-rounding term for dtypes whose
    own epsilon exceeds their accumulation epsilon (bf16)."""
    eps_acc = _ACC_EPS.get(str(dtype), 1.1920929e-07)
    eps_in = _COMPUTE_EPS.get(str(dtype), eps_acc)
    k = max(int(k), 1)
    depth = max(int(depth), 1)
    return max(2.0 * eps_acc * float((k + 1) * (depth + 1)) ** 0.5,
               4.0 * eps_in * float(k + 1) ** 0.5)


# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit:
# HBM3 bandwidth, and the peak for each operand type (f64: FP64 tensor
# cores; f32: CUDA cores; bf16: tensor cores)
H100_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}
_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2}


def stack_min_bytes(dtype: str, m: int, n: int, k: int, entries: int,
                    n_a: int, n_b: int, nruns: int) -> int:
    """Bytes one stack must move: each of the ``n_a`` A and ``n_b`` B
    blocks it references read once, its index arrays read once, each of
    the ``nruns`` C blocks read and written once."""
    return (_ITEMSIZE[dtype] * (n_a * m * k + n_b * k * n + 2 * nruns * m * n)
            + 4 * (2 * entries + 2 * nruns + 1))


def stack_bound_s(dtype: str, m: int, n: int, k: int, entries: int,
                  n_a: int, n_b: int, nruns: int) -> tuple:
    """Least time one stack can take on an H100, and what bounds it
    ("bytes" or "operations"): the larger of `stack_min_bytes` over the
    memory rate and its true flops over the type's peak.  The same for
    every stack kernel, since they compute the same function."""
    t_bytes = stack_min_bytes(dtype, m, n, k, entries, n_a, n_b, nruns) / H100_BYTES_PER_S
    t_ops = 2.0 * m * n * k * entries / H100_PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def crosspack_entries(plan) -> int:
    """Entry slots a crosspack plan's kernel walks, idle lanes included:
    each pack's P lanes for as many entries as the pack's longest run
    (the counterpart of the JAX package's `crosspack_launch_entries`,
    whose slots are the packed steps with their padding)."""
    return int(plan.pack[0] * plan.pack_longest.sum())
