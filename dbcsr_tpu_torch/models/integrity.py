"""Chain-invariant checks and rollback for the model loops.

Counterpart of `dbcsr_tpu/models/integrity.py`.  The ABFT probe
(`acc/abft.py`) guards single launches; an iterative chain multiplies
its own output, so one corrupted iterate that slips past it (ABFT off,
corruption between launches) would converge on garbage.  Each loop
therefore checks a cheap invariant on every fresh iterate (a Frobenius
norm growth bound from the submultiplicativity of its step polynomial,
plus trace bounds for purification) and, when it fails, rolls back to
the last accepted iterate (`core.mempool.chain.snapshot`/``restore``)
and recomputes the step: once on the unchanged engine, then on the safe
engine (`safe_engine`: the base stack kernel K1, ``"pallas"``, on the
stack format, the port's counterpart of the JAX package's ``"xla"``;
on CPU tensors K1 runs its plain version).

Armed like the stack guard's checks: when ``abft`` is not "off" or
faults are active (`guard_enabled`).  Unguarded, the loops run as
before, with the same histories.
"""

from __future__ import annotations

import contextlib
import math

from dbcsr_tpu_torch.acc import abft as _abft
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.obs import events as _events
from dbcsr_tpu_torch.obs import metrics as _metrics
from dbcsr_tpu_torch.resilience import faults as _faults


class ChainIntegrityError(RuntimeError):
    """A chain invariant failed, and still failed after the recompute on
    the safe engine: corruption the rollback cannot heal."""


def guard_enabled() -> bool:
    """The chain guard is armed by the ABFT knob or by active faults."""
    return _abft.enabled() or _faults.active()


def norm_ok(new_norm: float, limit: float) -> bool:
    """The growth bound on an iterate's Frobenius norm: ``limit`` comes
    from the submultiplicativity of the Frobenius norm over the step's
    polynomial (McWeeny: ``||3P²-2P³|| <= 3||P||² + 2||P||³``), a bound
    on any input, so it never fails a legitimate step, while a flip of
    order 2**10 on workload-scale values exceeds it.  NaN and inf fail."""
    return (math.isfinite(float(new_norm))
            and float(new_norm) <= float(limit) * (1.0 + 1e-9) + 1.0)


def record_rollback(model: str, step: int, reason: str, detail: str = "") -> None:
    """Count one rollback and publish a ``chain_rollback`` event."""
    _metrics.counter(
        "dbcsr_tpu_chain_rollback_total",
        "iterative-chain invariant violations rolled back to the last accepted "
        "iterate and recomputed, by model",
    ).inc(model=model)
    _events.publish("chain_rollback",
                    {"model": model, "step": step, "reason": reason, "detail": detail[:200]},
                    flight=True)


def record_recovery(model: str) -> None:
    _abft.record_recovery(f"chain:{model}")


def _matrices_of(cand) -> tuple:
    if isinstance(cand, BlockSparseMatrix):
        return (cand,)
    return tuple(m for m in cand if isinstance(m, BlockSparseMatrix))


def recompute_step(ch, build, validate, model: str, step: int, reason: str):
    """``build()`` once on the unchanged engine (a transient corruption
    does not recur, and the same engine repeats the clean run's bits),
    then, if ``validate`` still refuses it, once on the safe engine.
    Returns the first candidate accepted; raises `ChainIntegrityError`
    when both fail."""
    cand = build()
    if validate(cand):
        record_recovery(model)
        return cand
    for m in _matrices_of(cand):
        ch.retire(m)
    with safe_engine():
        cand = build()
    if validate(cand):
        record_recovery(model)
        return cand
    raise ChainIntegrityError(
        f"{model} step {step}: {reason} invariant still violated after the "
        f"unchanged-engine and safe-engine recomputes")


@contextlib.contextmanager
def safe_engine():
    """The safe engine for a rollback recompute: the base stack kernel
    (``mm_driver="pallas"``) with dense mode off.  On the card a
    recompute stays on a hand-written kernel; on CPU tensors this is the
    driver "auto" picks, so the recompute repeats the clean run's bits
    (the JAX package's ``"xla"`` is its CPU choice too)."""
    cfg = get_config()
    prev_driver, prev_dense = cfg.mm_driver, cfg.mm_dense
    set_config(mm_driver="pallas", mm_dense=False)
    try:
        yield
    finally:
        set_config(mm_driver=prev_driver, mm_dense=prev_dense)
