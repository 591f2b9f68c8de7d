"""Newton–Schulz sign-function iteration.

X_{k+1} = X_k (3 I - X_k^2) / 2 converges to sign(A) once A is
Gershgorin-scaled; each step is two filtered multiplies and a diagonal
shift.  Counterpart of `dbcsr_tpu/models/sign.py:33-142` without the
integrity guard, the adaptive-precision scope and the reuse events (not
ported: `ROADMAP.md`).
"""

from __future__ import annotations

from typing import Optional

from dbcsr_tpu_torch.core import mempool
from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY, BlockSparseMatrix
from dbcsr_tpu_torch.mm.multiply import multiply
from dbcsr_tpu_torch.ops.operations import (
    add_on_diag,
    added,
    copy,
    frobenius_norm,
    gershgorin_norm,
    scale,
)
from dbcsr_tpu_torch.ops.transformations import desymmetrize


def sign_step(x: BlockSparseMatrix,
              filter_eps: Optional[float] = None) -> BlockSparseMatrix:
    """One Newton–Schulz step: X' = X (3I - X²) / 2; X² is retired once
    the second multiply consumed it."""
    with mempool.chain() as ch:
        x2 = BlockSparseMatrix("X2", x.row_blk_sizes, x.col_blk_sizes, x.dtype, x.dist,
                               device=x.device)
        multiply("N", "N", 1.0, x, x, 0.0, x2, filter_eps=filter_eps)
        scale(x2, -1.0)  # T = 3I - X², in place on X²
        add_on_diag(x2, 3.0)
        out = BlockSparseMatrix("X'", x.row_blk_sizes, x.col_blk_sizes, x.dtype, x.dist,
                                device=x.device)
        multiply("N", "N", 0.5, x, x2, 0.0, out, filter_eps=filter_eps)
        ch.retire(x2)
        ch.detach(out)
    return out


def sign_iteration(a: BlockSparseMatrix, steps: int = 20,
                   filter_eps: Optional[float] = None, tol: float = 1e-10):
    """sign(A) by Newton–Schulz; returns (X, history), the history being
    ||X_k - X_{k-1}||_F per step; stops below ``tol``.  A symmetric kind
    is desymmetrized first (its iterates mix with plain products)."""
    if a.matrix_type != NO_SYMMETRY:
        a = desymmetrize(a)
    g = gershgorin_norm(a)
    x0 = x = scale(copy(a, name="X"), 1.0 / g if g > 0 else 1.0)
    history = []
    with mempool.chain() as ch:
        for _ in range(steps):
            x_new = sign_step(x, filter_eps=filter_eps)
            diff = added(x_new, x, 1.0, -1.0, name="diff")
            history.append(frobenius_norm(diff))
            ch.retire(diff)
            if x is not x0:
                ch.retire(x)
            x = x_new
            if history[-1] < tol:
                break
        ch.detach(x)
    return x, history
