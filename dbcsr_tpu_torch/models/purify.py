"""McWeeny density-matrix purification.

P_{n+1} = 3 P_n^2 - 2 P_n^3, the canonical linear-scaling-DFT workload
DBCSR serves (CP2K's `dm_ls_scf`): two filtered block-sparse multiplies
per step.  Counterpart of `dbcsr_tpu/models/purify.py:27-169,238-255`
without the integrity guard, the adaptive-precision scope and the reuse
events (not ported: `ROADMAP.md`), which the JAX package's default
leaves off, so both run the same loop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.core import mempool
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.device import DeviceLike
from dbcsr_tpu_torch.mm.multiply import multiply
from dbcsr_tpu_torch.ops.operations import add, add_on_diag, scale, trace
from dbcsr_tpu_torch.ops.test_methods import make_random_matrix
from dbcsr_tpu_torch.ops.transformations import desymmetrize


def _like(name: str, p: BlockSparseMatrix) -> BlockSparseMatrix:
    return BlockSparseMatrix(name, p.row_blk_sizes, p.col_blk_sizes, p.dtype, p.dist,
                             device=p.device)


def mcweeny_step(p: BlockSparseMatrix,
                 filter_eps: Optional[float] = None) -> BlockSparseMatrix:
    """One purification step; returns P'.  P³ is retired when the step
    ends and P' (P² updated in place by `add`) escapes the step's
    chain."""
    with mempool.chain() as ch:
        p2 = _like("P2", p)
        multiply("N", "N", 1.0, p, p, 0.0, p2, filter_eps=filter_eps)
        p3 = _like("P3", p)
        multiply("N", "N", 1.0, p2, p, 0.0, p3, filter_eps=filter_eps)
        out = add(p2, p3, 3.0, -2.0)  # P' = 3 P² - 2 P³
        ch.retire(p3)
        ch.detach(out)
    return out


def mcweeny_purify(p: BlockSparseMatrix, steps: int = 5,
                   filter_eps: Optional[float] = None, tol: Optional[float] = None):
    """Iterate purification; stop early when the trace moves less than
    ``tol``.  Returns (P_final, trace_history).  The loop shares one
    chain: each iterate is retired once its successor exists; the
    caller's input is never touched."""
    history = []
    with mempool.chain() as ch:
        cur = p
        for _ in range(steps):
            new = mcweeny_step(cur, filter_eps=filter_eps)
            if cur is not p:
                ch.retire(cur)
            cur = new
            history.append(trace(cur))
            if tol is not None and len(history) > 1 and abs(history[-1] - history[-2]) < tol:
                break
        ch.detach(cur)
    return cur, history


def make_test_density(n_blocks: int, block_size: int, occ: float = 0.2, seed: int = 0,
                      dtype=torch.float64,
                      device: Optional[DeviceLike] = None) -> BlockSparseMatrix:
    """A matrix with spectrum in [0, 1]-ish for purification tests:
    P0 = 0.5*I + a small random symmetric sparse part, drawn as the JAX
    package draws it (a symmetric matrix from ``seed``, scaled by
    0.1/sqrt(N), desymmetrized).  ``dtype`` and ``device`` are the
    port's additions."""
    rng = np.random.default_rng(seed)
    sizes = [block_size] * n_blocks
    p = make_random_matrix("P0", sizes, sizes, dtype=dtype, occupation=occ,
                           matrix_type="S", rng=rng, device=device)
    scale(p, 0.1 / max(1, n_blocks * block_size) ** 0.5)
    p = desymmetrize(p)
    add_on_diag(p, 0.5)
    return p
