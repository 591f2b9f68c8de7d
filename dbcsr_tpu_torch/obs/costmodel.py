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
