"""The yardstick of the kernels' roofline: published peaks and the count
of a block-sparse product's true flops and least bytes.

Peaks are those of NVIDIA's H100 SXM data sheet (dense rates, at the
card's full power limit of 700 W): 67 TFLOP/s in float64 on the FP64
tensor cores, 67 TFLOP/s in float32 outside the tensor cores, and
3.35 TB/s of HBM3; a complex type takes its real type's rate.  They are
frozen here; nothing in the environment changes them.

The count reads the operands' block patterns, never what ran, so it is
the same whatever kernel, format or driver computes the product:

- flops: 2 * m * n * k (8 * m * n * k for a complex type) summed over
  every block product C[i, j] += A[i, k] * B[k, j] that the patterns
  call for;
- least bytes: each A block and each B block that some product
  references is read once, each block C held before is read once when
  beta != 0, and each block of the result is written once.  Index
  arrays are not counted.

The least time of a product is the larger of flops over the peak rate
and least bytes over the peak bandwidth.  Over any busy time that
contains the product's work the share is at most 100%.
"""

from __future__ import annotations

import numpy as np

PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "complex128": 67e12, "complex64": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float64": 8, "float32": 4, "complex128": 16, "complex64": 8}
FLOPS_PER_MAC = {"float64": 2, "float32": 2, "complex128": 8, "complex64": 8}


def product_count(a_keys, b_keys, c0_keys, row_sizes, k_sizes, col_sizes,
                  beta: float, dtype: str = "float64") -> dict:
    """Count C = alpha * A @ B + beta * C0 from sorted block keys:
    ``a_keys`` are i * nk + k, ``b_keys`` k * nc + j and ``c0_keys`` (C's
    blocks before the product) i * nc + j.  Returns the products, true
    flops, least bytes and the result's sorted keys."""
    row_sizes = np.asarray(row_sizes, np.int64)
    k_sizes = np.asarray(k_sizes, np.int64)
    col_sizes = np.asarray(col_sizes, np.int64)
    nk, nc = len(k_sizes), len(col_sizes)
    a_keys = np.asarray(a_keys, np.int64)
    b_keys = np.asarray(b_keys, np.int64)
    c0_keys = np.asarray(c0_keys, np.int64)
    ai, ak = a_keys // nk, a_keys % nk
    bk, bj = b_keys // nc, b_keys % nc
    b_per_k = np.bincount(bk, minlength=nk)
    b_width = np.bincount(bk, weights=col_sizes[bj], minlength=nk)
    a_per_k = np.bincount(ak, minlength=nk)
    per_a = b_per_k[ak]
    products = int(per_a.sum())
    flops = FLOPS_PER_MAC[dtype] * int(
        (row_sizes[ai] * k_sizes[ak] * b_width[ak].astype(np.int64)).sum())
    # the result's pattern: C0's blocks and every (i, j) a product reaches
    b_start = np.searchsorted(bk, np.arange(nk))
    first = np.repeat(b_start[ak] - np.cumsum(per_a) + per_a, per_a)
    b_pos = first + np.arange(products)
    prod_keys = np.repeat(ai, per_a) * nc + bj[b_pos]
    c_keys = np.union1d(np.unique(prod_keys), c0_keys)
    elems = lambda keys, ncols, rs, cs: int((rs[keys // ncols] * cs[keys % ncols]).sum())
    a_read = elems(a_keys[per_a > 0], nk, row_sizes, k_sizes)
    b_read = elems(b_keys[a_per_k[bk] > 0], nc, k_sizes, col_sizes)
    c_read = elems(c0_keys, nc, row_sizes, col_sizes) if beta != 0 else 0
    c_write = elems(c_keys, nc, row_sizes, col_sizes)
    nbytes = (a_read + b_read + c_read + c_write) * ITEMSIZE[dtype]
    return {"products": products, "flops": flops, "bytes": nbytes, "c_keys": c_keys}


def least_time_s(flops: int, nbytes: int, dtype: str = "float64") -> float:
    """The least seconds the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def roofline_pct(least_s: float, busy_s: float):
    """The least time as a share of a busy time; None without one."""
    if busy_s <= 0:
        return None
    return 100.0 * least_s / busy_s
