"""Newton–Schulz inverse-square-root iteration: S -> S^-1/2.

The coupled iteration (CP2K's Löwdin orthogonalization on DBCSR)

    Y_0 = S / s,  Z_0 = I          (s = Gershgorin bound)
    T_k = (3 I - Z_k Y_k) / 2
    Y_{k+1} = Y_k T_k,  Z_{k+1} = T_k Z_k

with Z_k -> sqrt(s) S^-1/2: three filtered multiplies per step, whose
patterns repeat across steps.  Counterpart of
`dbcsr_tpu/models/invsqrt.py:35-228` without the integrity guard and the
reuse events (not ported: `ROADMAP.md`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from dbcsr_tpu_torch.core import mempool
from dbcsr_tpu_torch.core.kinds import host_dtype
from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY, BlockSparseMatrix
from dbcsr_tpu_torch.mm.multiply import multiply
from dbcsr_tpu_torch.ops.operations import (
    add_on_diag,
    copy,
    frobenius_norm,
    gershgorin_norm,
    scale,
)
from dbcsr_tpu_torch.ops.transformations import desymmetrize


def _like(name: str, s: BlockSparseMatrix) -> BlockSparseMatrix:
    return BlockSparseMatrix(name, s.row_blk_sizes, s.col_blk_sizes, s.dtype, s.dist,
                             device=s.device)


def invsqrt_step(y: BlockSparseMatrix, z: BlockSparseMatrix,
                 filter_eps: Optional[float] = None
                 ) -> Tuple[BlockSparseMatrix, BlockSparseMatrix]:
    """One coupled Newton–Schulz step: (Y, Z) -> (Y T, T Z); T is retired
    once both products consumed it."""
    with mempool.chain() as ch:
        t = _like("T", y)
        multiply("N", "N", 1.0, z, y, 0.0, t, filter_eps=filter_eps)
        scale(t, -0.5)  # T = (3I - Z Y) / 2
        add_on_diag(t, 1.5)
        y2 = _like("Y'", y)
        multiply("N", "N", 1.0, y, t, 0.0, y2, filter_eps=filter_eps)
        z2 = _like("Z'", z)
        multiply("N", "N", 1.0, t, z, 0.0, z2, filter_eps=filter_eps)
        ch.retire(t)
        ch.detach(y2)
        ch.detach(z2)
    return y2, z2


def invsqrt_iteration(s: BlockSparseMatrix, max_iter: int = 30, tol: float = 1e-10,
                      filter_eps: Optional[float] = None, history: Optional[list] = None
                      ) -> Tuple[BlockSparseMatrix, float, int]:
    """Iterate until ||I - Z Y||_F < ``tol``; returns (Z, scale_factor,
    iterations), the inverse square root being Z / sqrt(scale_factor).
    ``s`` must be symmetric positive definite.  ``history``, when given,
    receives each step's residual ||I - Z Y||_F (the port's addition)."""
    sf = gershgorin_norm(s)
    if sf <= 0:
        raise ValueError("gershgorin bound must be positive (SPD input)")
    y = desymmetrize(s) if s.matrix_type != NO_SYMMETRY else copy(s, name="Y")
    scale(y, 1.0 / sf)
    z = _identity_like(s)
    with mempool.chain() as ch:
        ch.adopt(y)
        ch.adopt(z)
        for it in range(max_iter):
            # R = I - Z Y doubles as the step's T = I + R/2
            r = _like("R", s)
            multiply("N", "N", -1.0, z, y, 0.0, r, filter_eps=filter_eps)
            add_on_diag(r, 1.0)
            res = frobenius_norm(r)
            if history is not None:
                history.append(res)
            if res < tol:
                ch.detach(z)
                return z, sf, it
            t = r
            scale(t, 0.5)
            add_on_diag(t, 1.0)
            y2 = _like("Y'", s)
            multiply("N", "N", 1.0, y, t, 0.0, y2, filter_eps=filter_eps)
            z2 = _like("Z'", s)
            multiply("N", "N", 1.0, t, z, 0.0, z2, filter_eps=filter_eps)
            ch.retire(t)
            ch.retire(y)
            ch.retire(z)
            y, z = y2, z2
        ch.detach(z)
    return z, sf, max_iter


def _identity_like(s: BlockSparseMatrix) -> BlockSparseMatrix:
    """Block identity on s's row blocking."""
    eye = BlockSparseMatrix("I", s.row_blk_sizes, s.row_blk_sizes, s.dtype, s.dist,
                            device=s.device)
    for i, sz in enumerate(s.row_blk_sizes):
        eye.put_block(i, i, np.eye(int(sz), dtype=host_dtype(s.dtype)))
    return eye.finalize()
