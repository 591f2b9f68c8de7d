"""McWeeny density-matrix purification.

P_{n+1} = 3 P_n^2 - 2 P_n^3, the canonical linear-scaling-DFT workload
DBCSR serves (CP2K's `dm_ls_scf`): two filtered block-sparse multiplies
per step.  Counterpart of `dbcsr_tpu/models/purify.py` (the
distributed steps, :172-235, run on `parallel/`), with the integrity
guard (`models/integrity.py`), the adaptive-precision chain scope
(`acc.precision.chain_scope`, on the trace change; inert unless
``precision="adaptive"`` and ABFT are on) and one ``model_reuse`` event
per step (`mm.incremental.reuse_delta`).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.acc import precision as _precision
from dbcsr_tpu_torch.core import mempool
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.device import DeviceLike
from dbcsr_tpu_torch.mm import incremental as _incremental
from dbcsr_tpu_torch.mm.multiply import multiply
from dbcsr_tpu_torch.obs import events as _events
from dbcsr_tpu_torch.models import integrity as _integrity
from dbcsr_tpu_torch.ops.operations import add, add_on_diag, frobenius_norm, scale, trace
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


def _purify_invariant(new: BlockSparseMatrix, norm_ref: float, history) -> tuple:
    """The integrity invariant of a purification iterate (ref
    `dbcsr_tpu/models/purify.py:51-83`): the norm growth bound, and,
    while the iterate can be a density matrix, the trace inside [0, N]
    and the trace change at most 4 times the last.  Returns (ok, trace,
    norm)."""
    tr = trace(new)
    nn = frobenius_norm(new)
    n = new.nfullrows
    slack = 0.5 + 1e-6 * n
    # ||3P²-2P³||_F <= 3||P||² + 2||P||³ on any input
    ok = _integrity.norm_ok(nn, 3.0 * norm_ref ** 2 + 2.0 * norm_ref ** 3)
    # spectra in [-0.5, 1.5] imply ||P||_F <= 1.5 sqrt(N)
    if ok and norm_ref <= 1.5 * n ** 0.5 + 1.0:
        ok = math.isfinite(tr) and -slack <= tr <= n + slack
        if ok and len(history) >= 2:
            d_prev = abs(history[-1] - history[-2])
            ok = abs(tr - history[-1]) <= max(4.0 * d_prev, d_prev + 1.0)
    return ok, tr, nn


def mcweeny_purify(p: BlockSparseMatrix, steps: int = 5,
                   filter_eps: Optional[float] = None, tol: Optional[float] = None):
    """Iterate purification; stop early when the trace moves less than
    ``tol``.  Returns (P_final, trace_history).  The loop shares one
    chain: each iterate is retired once its successor exists; the
    caller's input is never touched.

    Integrity guard (`models/integrity.py`, armed when ``abft`` is on or
    faults are active): the accepted iterate is checkpointed before each
    step, the new one is held to `_purify_invariant`, and a violating
    step rolls back to the checkpoint and is recomputed."""
    guard = _integrity.guard_enabled()
    history = []
    with mempool.chain() as ch, _precision.chain_scope(
            "purify", dtype=p.dtype, scale=float(max(p.nfullrows, 1))) as psc:
        cur = p
        cur_norm = frobenius_norm(cur) if guard else None
        for step_i in range(steps):
            reuse0 = _incremental.stats_snapshot()
            snap = ch.snapshot(cur) if guard else None
            new = mcweeny_step(cur, filter_eps=filter_eps)
            tr_new = None
            if guard:
                ok, tr_new, nn = _purify_invariant(new, cur_norm, history)
                if not ok:
                    _integrity.record_rollback("purify", step_i, "invariant",
                                               detail=f"norm {nn:.3e} ref {cur_norm:.3e}")
                    ch.retire(new)
                    if cur is not p:
                        cur = ch.restore(snap)
                    seen = {}

                    def _build(cur=cur):
                        return mcweeny_step(cur, filter_eps=filter_eps)

                    def _validate(cand):
                        ok2, seen["tr"], seen["nn"] = _purify_invariant(cand, cur_norm, history)
                        return ok2

                    new = _integrity.recompute_step(ch, _build, _validate, "purify", step_i,
                                                    "invariant")
                    nn, tr_new = seen["nn"], seen["tr"]
                cur_norm = nn
            if cur is not p:
                ch.retire(cur)
            cur = new
            # the guard already paid trace(new)
            history.append(trace(cur) if tr_new is None else tr_new)
            psc.observe(abs(history[-1] - history[-2]) if len(history) > 1 else float("inf"))
            _events.publish("model_reuse", dict(model="purify", step=step_i,
                                                **_incremental.reuse_delta(reuse0)))
            if tol is not None and len(history) > 1 and abs(history[-1] - history[-2]) < tol:
                break
        ch.detach(cur)
    return cur, history


def mcweeny_step_distributed(p_a, p_b):
    """One purification step on the grid with dense panels: P in both
    Cannon roles (`parallel.distribute(p, grid, "A")` and "B", the
    analog of the reference's left/right image distributions,
    `dbcsr_mm_dist_operations.F:58`); returns P' = 3 P² - 2 P³ in the C
    role, evaluated as C2 = P@P, then 3*C2 - 2*(P@C2)."""
    from dbcsr_tpu_torch.parallel.dist_matrix import DistMatrix, multiply_distributed

    p2 = multiply_distributed(1.0, p_a, p_b)  # role C
    # P² in the B role for the second product (the canvas is the same;
    # the role says how the Cannon cuts it into panels)
    p2_b = DistMatrix(data=p2.data, row_blk_sizes=p2.row_blk_sizes,
                      col_blk_sizes=p2.col_blk_sizes, bm=p2.bm, bn=p2.bn,
                      nbr_pad=p2.nbr_pad, nbc_pad=p2.nbc_pad, mesh=p2.mesh, role="B",
                      name="P2", dtype=p2.dtype)
    p3 = multiply_distributed(1.0, p_a, p2_b)  # P³ = P @ P²
    return DistMatrix(data=3.0 * p2.data - 2.0 * p3.data, row_blk_sizes=p2.row_blk_sizes,
                      col_blk_sizes=p2.col_blk_sizes, bm=p2.bm, bn=p2.bn,
                      nbr_pad=p2.nbr_pad, nbc_pad=p2.nbc_pad, mesh=p2.mesh, role="C",
                      name="P'", dtype=p2.dtype)


def mcweeny_step_sparse_distributed(p: BlockSparseMatrix, mesh,
                                    filter_eps: Optional[float] = None) -> BlockSparseMatrix:
    """One purification step through the block-sparse grid Cannon
    (`parallel/sparse_dist.py`): P' = 3 P² - 2 P³, with the products'
    blocks filtered at ``filter_eps``."""
    from dbcsr_tpu_torch.ops.operations import filter_matrix
    from dbcsr_tpu_torch.parallel.sparse_dist import sparse_multiply_distributed

    p2 = sparse_multiply_distributed(1.0, p, p, 0.0, None, mesh, name="P2")
    if filter_eps is not None:
        filter_matrix(p2, filter_eps)
    p3 = sparse_multiply_distributed(1.0, p2, p, 0.0, None, mesh, name="P3")
    if filter_eps is not None:
        filter_matrix(p3, filter_eps)
    return add(p2, p3, 3.0, -2.0)


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
