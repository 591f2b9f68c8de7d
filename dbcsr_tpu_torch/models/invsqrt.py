"""Newton–Schulz inverse-square-root iteration: S -> S^-1/2.

The coupled iteration (CP2K's Löwdin orthogonalization on DBCSR)

    Y_0 = S / s,  Z_0 = I          (s = Gershgorin bound)
    T_k = (3 I - Z_k Y_k) / 2
    Y_{k+1} = Y_k T_k,  Z_{k+1} = T_k Z_k

with Z_k -> sqrt(s) S^-1/2: three filtered multiplies per step, whose
patterns repeat across steps.  Counterpart of
`dbcsr_tpu/models/invsqrt.py:35-228`, with the integrity guard
(`models/integrity.py`), the adaptive-precision chain scope
(`acc.precision.chain_scope`, on the residual) and one ``model_reuse``
event per step (`mm.incremental.reuse_delta`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from dbcsr_tpu_torch.acc import precision as _precision
from dbcsr_tpu_torch.core import mempool
from dbcsr_tpu_torch.core.kinds import host_dtype
from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY, BlockSparseMatrix
from dbcsr_tpu_torch.mm import incremental as _incremental
from dbcsr_tpu_torch.mm.multiply import multiply
from dbcsr_tpu_torch.obs import events as _events
from dbcsr_tpu_torch.models import integrity as _integrity
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
    receives each step's residual ||I - Z Y||_F (the port's addition).

    Integrity guard (`models/integrity.py`): the residual must stay under
    its submultiplicative bound and contract, and the new Y and Z under
    theirs, checked before the previous iterates retire; a violation
    recomputes the residual, or the step, from the still-live y, z and
    t."""
    sf = gershgorin_norm(s)
    if sf <= 0:
        raise ValueError("gershgorin bound must be positive (SPD input)")
    y = desymmetrize(s) if s.matrix_type != NO_SYMMETRY else copy(s, name="Y")
    scale(y, 1.0 / sf)
    z = _identity_like(s)
    guard = _integrity.guard_enabled()
    prev_res = None
    with mempool.chain() as ch, _precision.chain_scope(
            "invsqrt", dtype=s.dtype, scale=float(max(s.nfullrows, 1)) ** 0.5) as psc:
        ch.adopt(y)
        ch.adopt(z)
        ny = frobenius_norm(y) if guard else None
        nz = frobenius_norm(z) if guard else None
        for it in range(max_iter):
            reuse0 = _incremental.stats_snapshot()
            # R = I - Z Y doubles as the step's T = I + R/2
            r = _like("R", s)
            multiply("N", "N", -1.0, z, y, 0.0, r, filter_eps=filter_eps)
            add_on_diag(r, 1.0)
            res = frobenius_norm(r)
            # ||I - Z Y||_F <= sqrt(N) + ||Z|| ||Y|| on any input
            res_limit = (s.nfullrows ** 0.5 + nz * ny) if guard else None

            def _res_ok(val, res_limit=res_limit, prev=prev_res):
                return (math.isfinite(val) and _integrity.norm_ok(val, res_limit)
                        and (prev is None or val <= max(4.0 * prev, prev + 1.0)))

            if guard and not _res_ok(res):
                # the residual's own multiply was corrupted: recompute it
                # from the still-live, accepted y and z
                _integrity.record_rollback("invsqrt", it, "residual",
                                           detail=f"res {res:.3e} prev {prev_res!r}")
                ch.retire(r)
                seen = {}

                def _build_r(y=y, z=z):
                    r2 = _like("R", s)
                    multiply("N", "N", -1.0, z, y, 0.0, r2, filter_eps=filter_eps)
                    add_on_diag(r2, 1.0)
                    return r2

                def _validate_r(cand):
                    seen["res"] = frobenius_norm(cand)
                    return _res_ok(seen["res"])

                r = _integrity.recompute_step(ch, _build_r, _validate_r, "invsqrt", it,
                                              "residual")
                res = seen["res"]
            if history is not None:
                history.append(res)
            psc.observe(res)
            if res < tol:
                ch.detach(z)
                return z, sf, it
            prev_res = res
            t = r
            scale(t, 0.5)
            add_on_diag(t, 1.0)
            y2 = _like("Y'", s)
            multiply("N", "N", 1.0, y, t, 0.0, y2, filter_eps=filter_eps)
            z2 = _like("Z'", s)
            multiply("N", "N", 1.0, t, z, 0.0, z2, filter_eps=filter_eps)
            if guard:
                # ||Y T||_F <= ||Y||_F ||T||_F on any input
                nt = frobenius_norm(t)
                ny2, nz2 = frobenius_norm(y2), frobenius_norm(z2)
                if not (_integrity.norm_ok(ny2, ny * nt) and _integrity.norm_ok(nz2, nt * nz)):
                    _integrity.record_rollback("invsqrt", it, "invariant",
                                               detail=f"|Y'| {ny2:.3e} |Z'| {nz2:.3e}")
                    ch.retire(y2)
                    ch.retire(z2)
                    seen = {}

                    def _build_yz(y=y, z=z, t=t):
                        ya = _like("Y'", s)
                        multiply("N", "N", 1.0, y, t, 0.0, ya, filter_eps=filter_eps)
                        za = _like("Z'", s)
                        multiply("N", "N", 1.0, t, z, 0.0, za, filter_eps=filter_eps)
                        return ya, za

                    def _validate_yz(cand, nt=nt):
                        ya, za = cand
                        seen["ny"] = frobenius_norm(ya)
                        seen["nz"] = frobenius_norm(za)
                        return (_integrity.norm_ok(seen["ny"], ny * nt)
                                and _integrity.norm_ok(seen["nz"], nt * nz))

                    y2, z2 = _integrity.recompute_step(ch, _build_yz, _validate_yz, "invsqrt",
                                                       it, "invariant")
                    ny2, nz2 = seen["ny"], seen["nz"]
                ny, nz = ny2, nz2
            _events.publish("model_reuse", dict(model="invsqrt", step=it,
                                                **_incremental.reuse_delta(reuse0)))
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
