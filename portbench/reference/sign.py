"""The plain reference of the sign cell: sign(A) by the Newton–Schulz
iteration of CP2K's linear-scaling SCF (``LS_SCF``,
``PURIFICATION_METHOD SIGN``), worked out on the dense matrix, with
DBCSR's filter applied at block granularity.

The iteration, as `dbcsr_tpu_torch.models.sign_iteration` states it:
X0 = A * (1 / g), g the Gershgorin norm max_i sum_j |a_ij|; each step
X' = X (3I - X²) / 2 as two filtered products, X² and then
0.5 * X * T with T = 3I - X² (X²'s pattern and the whole block
diagonal); it stops once ||X' - X||_F < tol, or after ``steps`` steps.

Each product C = alpha * A * B into an empty C follows DBCSR's filter
(`dbcsr_mm_cannon.F:1098-1105`, as `mm/multiply.py:_candidates` cites
it): a block product A_ik B_kj is kept when
||A_ik||² ||B_kj||² >= (eps / max(1, blocks in row i of A))², the
squared norms and the threshold in float32; C's pattern is every (i, j)
that a kept product reaches; then C's blocks with ||C_ij||² < eps² are
dropped (`multiply_filter`).  When no product drops, the product is one
GEMM of the dense matrices (an absent block is zero and adds nothing);
otherwise a block-masked contraction, one block row at a time.  Blocks
are square and of one size.

Plain PyTorch and NumPy only: nothing of the program is imported, and of
the program's answer only the blocks under judgement are read
(`dense_answer`).  TF32 is off in every matmul.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.blocksparse import Operand, densify, no_tf32


@dataclasses.dataclass
class SignResult:
    x: torch.Tensor  # dense sign(A) in the iteration's dtype
    pattern: torch.Tensor  # (n, n) bool: X's stored blocks
    steps: int
    history: list  # ||X_k - X_{k-1}||_F per step
    products: dict  # over every product: "candidates", "dropped"
    blocks: dict  # C's post-filter over every product: "kept", "dropped"
    multiplies: list  # (A's keys, B's keys) of each product, sorted


def blocks_of(x: torch.Tensor, bs: int) -> torch.Tensor:
    """An (n * bs, n * bs) matrix as an (n, n, bs, bs) view of its blocks."""
    n = x.shape[0] // bs
    return x.view(n, bs, n, bs).permute(0, 2, 1, 3)


def block_norms(x: torch.Tensor, bs: int) -> torch.Tensor:
    """Each block's Frobenius norm, (n, n), in ``x``'s dtype."""
    xb = blocks_of(x, bs)
    return torch.sqrt((xb * xb).sum(dim=(2, 3)))


def pattern_keys(pattern: torch.Tensor) -> np.ndarray:
    """Sorted keys (row * ncols + col) of a block pattern."""
    return np.flatnonzero(pattern.cpu().numpy()).astype(np.int64)


def filtered_product(alpha: float, a, pa, b, pb, bs: int, eps: float) -> tuple:
    """C = alpha * A * B into an empty C under the filter: (dense C, its
    pattern, candidates, dropped products, C's blocks kept, dropped)."""
    cand = pa[:, :, None] & pb[None, :, :]  # (i, k, j)
    na2 = block_norms(a, bs).to(torch.float32) ** 2
    nb2 = block_norms(b, bs).to(torch.float32) ** 2
    rows = pa.sum(dim=1).clamp(min=1).to(torch.float32)
    row_eps = (torch.tensor(eps, dtype=torch.float32, device=a.device) / rows) ** 2
    keep = cand & (na2[:, :, None] * nb2[None, :, :] >= row_eps[:, None, None])
    candidates, kept = int(cand.sum()), int(keep.sum())
    with no_tf32():
        if kept == candidates:
            c = alpha * (a @ b)
        else:
            c = torch.zeros_like(a)
            ab, bb, cb = blocks_of(a, bs), blocks_of(b, bs), blocks_of(c, bs)
            for i in range(pa.shape[0]):
                m = keep[i].to(a.dtype)  # (k, j)
                if m.any():
                    prod = torch.einsum("kab,kjbc->kjac", ab[i], bb)
                    cb[i] = alpha * (prod * m[:, :, None, None]).sum(dim=0)
    pc = keep.any(dim=1)
    small = pc & ~(block_norms(c, bs) ** 2 >= float(eps) ** 2)
    lost = int(small.sum())
    if lost:
        blocks_of(c, bs)[small] = 0
        pc = pc & ~small
    return c, pc, candidates, candidates - kept, int(pc.sum()), lost


def iterate(a: torch.Tensor, pattern: torch.Tensor, bs: int, steps: int,
            filter_eps: float, tol: float) -> SignResult:
    """sign(A) of the dense ``a`` (its stored blocks ``pattern``) in
    ``a``'s dtype."""
    g = float(a.abs().sum(dim=1).max())
    x = a * (1.0 / g if g > 0 else 1.0)
    px = pattern.clone()
    eye = torch.eye(pattern.shape[0], dtype=torch.bool, device=pattern.device)
    history, mults = [], []
    products = {"candidates": 0, "dropped": 0}
    blocks = {"kept": 0, "dropped": 0}

    def product(alpha, l, pl, r, pr):
        c, pc, cand, drop, kept, lost = filtered_product(alpha, l, pl, r, pr, bs, filter_eps)
        mults.append((pattern_keys(pl), pattern_keys(pr)))
        products["candidates"] += cand
        products["dropped"] += drop
        blocks["kept"] += kept
        blocks["dropped"] += lost
        return c, pc

    for _ in range(steps):
        x2, p2 = product(1.0, x, px, x, px)
        t = -x2
        t.diagonal().add_(3.0)
        x_new, p_new = product(0.5, x, px, t, p2 | eye)
        history.append(float(torch.linalg.norm(x_new - x)))
        x, px = x_new, p_new
        if history[-1] < tol:
            break
    return SignResult(x, px, len(history), history, products, blocks, mults)


def dense_answer(got: list, got_keys: np.ndarray, sizes, device) -> torch.Tensor:
    """A program's X as a dense float64 matrix, from its blocks given as
    shape groups [((bm, bn), sorted keys, slots, data)], block
    ``keys[i]`` lying at ``data[slots[i]]``, and ``got_keys`` all its
    keys, sorted."""
    groups = []
    for shape, keys, slots, data in got:
        vals = data.index_select(0, torch.from_numpy(slots).to(data.device))
        groups.append((shape, np.searchsorted(got_keys, keys), vals))
    sizes = np.asarray(sizes, np.int64)
    return densify(Operand(np.asarray(got_keys, np.int64), sizes, sizes, groups),
                   torch.float64, device)


def judge(got_x: torch.Tensor, got_keys: np.ndarray, got_steps: int, want: SignResult,
          trace: float) -> dict:
    """An answer against the reference: blocks in one pattern and not the
    other (``pattern_mismatch``), the largest difference over the
    largest reference value (``rel_err``), the gap between the step
    counts (``steps_mismatch``) and between the answer's trace and the
    input's invariant ``trace`` (``trace_err``); besides, the largest
    absolute difference (``abs_diff``) and the largest reference value
    (``scale``)."""
    ref_x = want.x.to(torch.float64)
    x = got_x.to(torch.float64)
    diff = float((x - ref_x).abs().max())
    scale = float(ref_x.abs().max())
    return {"pattern_mismatch": len(np.setxor1d(got_keys, pattern_keys(want.pattern))),
            "rel_err": diff / max(scale, 1e-300),
            "steps_mismatch": abs(int(got_steps) - want.steps),
            "trace_err": abs(float(torch.diagonal(x).sum()) - trace),
            "abs_diff": diff, "scale": scale}
