"""Newton–Schulz sign-function iteration.

X_{k+1} = X_k (3 I - X_k^2) / 2 converges to sign(A) once A is
Gershgorin-scaled; each step is two filtered multiplies and a diagonal
shift.  Counterpart of `dbcsr_tpu/models/sign.py:33-142`, with the
integrity guard (`models/integrity.py`), the adaptive-precision chain
scope (`acc.precision.chain_scope`, on ||X_k - X_{k-1}||_F) and one
``model_reuse`` event per step (`mm.incremental.reuse_delta`).
"""

from __future__ import annotations

import math
from typing import Optional

from dbcsr_tpu_torch.acc import precision as _precision
from dbcsr_tpu_torch.core import mempool
from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY, BlockSparseMatrix
from dbcsr_tpu_torch.mm import incremental as _incremental
from dbcsr_tpu_torch.mm.multiply import multiply
from dbcsr_tpu_torch.obs import events as _events
from dbcsr_tpu_torch.models import integrity as _integrity
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
    is desymmetrized first (its iterates mix with plain products).

    Integrity guard (`models/integrity.py`): the accepted iterate is
    checkpointed before each step and the new one held to the
    Newton–Schulz norm growth bound; a violating step rolls back and is
    recomputed."""
    if a.matrix_type != NO_SYMMETRY:
        a = desymmetrize(a)
    g = gershgorin_norm(a)
    x0 = x = scale(copy(a, name="X"), 1.0 / g if g > 0 else 1.0)
    guard = _integrity.guard_enabled()
    history = []
    with mempool.chain() as ch, _precision.chain_scope(
            "sign", dtype=a.dtype, scale=float(max(a.nfullrows, 1)) ** 0.5) as psc:
        x_norm = frobenius_norm(x) if guard else None
        for step_i in range(steps):
            reuse0 = _incremental.stats_snapshot()
            snap = ch.snapshot(x) if guard else None
            x_new = sign_step(x, filter_eps=filter_eps)
            diff = added(x_new, x, 1.0, -1.0, name="diff")
            metric = frobenius_norm(diff)
            if guard:
                nn = frobenius_norm(x_new)
                # ||X(3I - X²)/2||_F <= (3 sqrt(N) ||X|| + ||X||³) / 2 on any input
                limit = 0.5 * (3.0 * x.nfullrows ** 0.5 * x_norm + x_norm ** 3)
                if not (_integrity.norm_ok(nn, limit) and math.isfinite(metric)):
                    _integrity.record_rollback("sign", step_i, "invariant",
                                               detail=f"norm {nn:.3e} ref {x_norm:.3e}")
                    ch.retire(diff)
                    ch.retire(x_new)
                    x = ch.restore(snap)
                    seen = {}

                    def _build(x=x):
                        xn = sign_step(x, filter_eps=filter_eps)
                        return xn, added(xn, x, 1.0, -1.0, name="diff")

                    def _validate(cand, limit=limit):
                        xn, df = cand
                        seen["metric"] = frobenius_norm(df)
                        seen["nn"] = frobenius_norm(xn)
                        return (_integrity.norm_ok(seen["nn"], limit)
                                and math.isfinite(seen["metric"]))

                    x_new, diff = _integrity.recompute_step(ch, _build, _validate, "sign",
                                                            step_i, "invariant")
                    metric, nn = seen["metric"], seen["nn"]
                x_norm = nn
            history.append(metric)
            psc.observe(metric)
            _events.publish("model_reuse", dict(model="sign", step=step_i,
                                                **_incremental.reuse_delta(reuse0)))
            ch.retire(diff)
            if x is not x0:
                ch.retire(x)
            x = x_new
            if history[-1] < tol:
                break
        ch.detach(x)
    return x, history
