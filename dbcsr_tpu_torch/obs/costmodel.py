"""Cost model and tolerances: the subset of `dbcsr_tpu/obs/costmodel.py`
the stack path uses (its own copy: the port imports nothing of the JAX
package).
"""

from __future__ import annotations

# machine epsilon of the accumulation dtype (bf16 accumulates in f32;
# a complex dtype in its real part's precision)
_ACC_EPS = {
    "float64": 2.220446049250313e-16,
    "complex128": 2.220446049250313e-16,
    "float32": 1.1920929e-07,
    "complex64": 1.1920929e-07,
    "bfloat16": 1.1920929e-07,
}
# machine epsilon of each dtype's own representation (input rounding,
# and the compute dtype of a demoted stack)
_COMPUTE_EPS = {
    "float64": 2.220446049250313e-16,
    "complex128": 2.220446049250313e-16,
    "float32": 1.1920929e-07,
    "complex64": 1.1920929e-07,
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


def form_tolerance(dtype: str, precision, k: int, depth: int) -> float:
    """Relative tolerance of a kernel form against its own plain version
    or oracle: ``precision`` None is the native form; a demoted form
    rounds the same operands in both, so only the order of the sums
    differs.  A compensated form sums its products in the data's dtype;
    an uncompensated one sums each k-deep product in float32 and the
    run in the data's dtype."""
    if precision is None or precision[1]:
        return kernel_validation_tolerance(dtype, k, depth)
    return max(kernel_validation_tolerance("float32", k, depth if dtype == "float32" else 1),
               kernel_validation_tolerance(dtype, k, depth))


def abft_tolerance(dtype: str, k: int, depth: int) -> float:
    """Relative tolerance of an ABFT probe comparison (`acc/abft.py`):
    ``C·v`` against ``A·(B·v)`` is one bilinear form summed in two
    orders, so they differ by rounding only, bounded by the
    accumulation epsilon times the reduction lengths (``k`` terms per
    product, ``depth`` accumulated per C block) with the JAX package's
    margin (`dbcsr_tpu/obs/costmodel.py:200-213`)."""
    eps = _ACC_EPS.get(str(dtype), 1.1920929e-07)
    k = max(int(k), 1)
    depth = max(int(depth), 1)
    return 64.0 * eps * (k + 1) * float(depth + 1) ** 0.5


def effective_epsilon(compute: str, compensated: bool) -> float:
    """Per-product relative rounding of a demoted compute scheme
    (`acc/precision.py`): the compute dtype's epsilon, or, with the
    two-product compensation (hi/lo splits restoring every cross term
    but lo*lo), its square with a x4 margin for the recombination's
    roundings (`dbcsr_tpu/obs/costmodel.py:189`)."""
    eps = _COMPUTE_EPS.get(str(compute), 2.0 ** -8)
    return 4.0 * eps * eps if compensated else eps


def demoted_abft_tolerance(dtype: str, compute: str, compensated: bool,
                           k: int, depth: int) -> float:
    """The probe ceiling of a launch run at a demoted compute dtype
    (`dbcsr_tpu/obs/costmodel.py:216`): the effective epsilon with the
    native tolerance's x64 margin (the probe's scale already bounds the
    sum of |terms|), plus, for the uncompensated form, which sums each
    k-deep block product in the compute family's narrow accumulator
    (float32), a k-deep term; never tighter than the native tolerance."""
    tol = 64.0 * effective_epsilon(compute, compensated)
    if not compensated:
        tol += 8.0 * _ACC_EPS.get(str(compute), 1.1920929e-07) * max(int(k), 1)
    return max(tol, abft_tolerance(dtype, k, depth))


# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit:
# HBM3 bandwidth, and the peak for each operand type (f64: FP64 tensor
# cores; f32: CUDA cores; bf16: tensor cores); a complex type runs on
# its real part's units
H100_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12,
                   "complex128": 67e12, "complex64": 67e12}
_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "complex128": 16, "complex64": 8}
# real operations per multiply-add: a complex one is 4 real multiply-adds
# (`dbcsr_tpu/obs/costmodel.py:peak_gflops`, :358-370)
_MAC_OPS = {"complex128": 8, "complex64": 8}


def stack_min_bytes(dtype: str, m: int, n: int, k: int, entries: int,
                    n_a: int, n_b: int, nruns: int) -> int:
    """Bytes one stack must move: each of the ``n_a`` A and ``n_b`` B
    blocks it references read once, its index arrays read once, each of
    the ``nruns`` C blocks read and written once."""
    return (_ITEMSIZE[dtype] * (n_a * m * k + n_b * k * n + 2 * nruns * m * n)
            + 4 * (2 * entries + 2 * nruns + 1))


def stack_bound_s(dtype: str, m: int, n: int, k: int, entries: int,
                  n_a: int, n_b: int, nruns: int, precision=None) -> tuple:
    """Least time one stack can take on an H100, and what bounds it
    ("bytes" or "operations"): the larger of `stack_min_bytes` over the
    memory rate and its real operations over the type's peak (a complex
    multiply-add counts 8).  The same for every stack kernel, since they
    compute the same function.  A demoted ``precision`` spec moves the
    same bytes and does its operations at the compute dtype's peak, three
    products each when compensated."""
    t_bytes = stack_min_bytes(dtype, m, n, k, entries, n_a, n_b, nruns) / H100_BYTES_PER_S
    ops = _MAC_OPS.get(dtype, 2) * float(m) * n * k * entries
    if precision is None:
        t_ops = ops / H100_PEAK_FLOPS[dtype]
    else:
        t_ops = ops * (3 if precision[1] else 1) / H100_PEAK_FLOPS[precision[0]]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def crosspack_entries(plan) -> int:
    """Entry slots a crosspack plan's kernel walks, idle lanes included:
    each pack's P lanes for as many entries as the pack's longest run
    (the counterpart of the JAX package's `crosspack_launch_entries`,
    whose slots are the packed steps with their padding)."""
    return int(plan.pack[0] * plan.pack_longest.sum())
