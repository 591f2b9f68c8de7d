"""ABFT probe checksums: catching wrong but finite answers.

Counterpart of the stack and canvas parts of `dbcsr_tpu/acc/abft.py`.
For one stack ``C[ci] += alpha * A[ai] @ B[bi]`` and fixed Rademacher
vectors ``u`` (rows) and ``v`` (columns), the rank-1 identity

    u · (C_new - C_old) · v  ==  alpha * Σ_s (uᵀA)[ai_s] · (B v)[bi_s]

holds per C block in exact arithmetic; in floating point the two sides
differ by rounding only, bounded by `obs.costmodel.abft_tolerance`.
``uᵀA`` and ``B·v`` contract once per block of the A and B bins, each
entry then costs one k-long dot, and the entries' dots sum per C block
with one `index_add_`: plain torch on the device, as the JAX package
computes the probe in XLA (no Pallas kernel).  A corrupted element
(i, j) of C enters the left side with weight ``u_i·v_j = ±1``, so a
single-element corruption is never masked.

The knob is ``abft`` in `core.config`: "off" (no probe), "verify"
(probe every launch; a mismatch raises `AbftMismatchError`, which
`acc.smm` classifies "sdc", records against the driver's breaker and
answers by re-executing the stack: the same driver from the pristine C
first, then down the failover chain), "recover" (verify, and every
recovery is probed before it is accepted; under "verify" the JAX
package probes recoveries too, `acc/smm.py:_run_candidate`; the port's
`acc/smm.py:_attempt`).

A launch into a C bin that is still all zeros (``c_zero``, a beta = 0
product's first touch) may defer its probe (`check_stack` with
``defer``): the ``[err, scale]`` pair stays on the device, and
`mm.multiply` drains every pair of the product with one host sync in
`flush`, redoing the product with immediate checks on a mismatch.  An
immediate check costs one sync per launch.

`check_dense_canvas` and `check_dense_canvas_batched` probe the dense
and composite formats' canvases.  Not ported yet (`ROADMAP.md`):
`check_superstack`, `tree_probe`/`shift_conserved`, `matrix_probe`,
`verify_product` and the adaptive-precision ceilings
(`PrecisionExceededError`); they come with the superstack, parallel,
serve and precision modules.

Every probe, mismatch and recovery is counted:
``dbcsr_tpu_abft_{checks,mismatches,recoveries}_total{driver}``, with
``abft_mismatch``/``abft_recovery`` events.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.core.config import get_config
from dbcsr_tpu_torch.core.kinds import name_of
from dbcsr_tpu_torch.obs import costmodel as _costmodel
from dbcsr_tpu_torch.obs import events as _events
from dbcsr_tpu_torch.obs import metrics as _metrics

# the probe's left side reads C a bounded chunk of blocks at a time
_CHUNK_BYTES = 256 * 1024 * 1024


class AbftMismatchError(RuntimeError):
    """A probe checksum disagreed beyond tolerance: the launch produced a
    wrong, possibly finite, answer.  Classified "sdc" by
    `acc.smm._classify_failure`."""


def mode() -> str:
    return get_config().abft


def enabled() -> bool:
    """The hot-path gate: one config read per launch."""
    return get_config().abft != "off"


def recover_enabled() -> bool:
    return get_config().abft == "recover"


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The probe's accumulation dtype (bf16 accumulates in float32)."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


_vec_cache: dict = {}


def probe_vector(n: int, dtype: torch.dtype, salt: int = 0, device=None) -> torch.Tensor:
    """The fixed Rademacher (±1) probe vector of length ``n``: the same
    values as the JAX package's (`np.random.default_rng(0xAB5D + salt)`),
    in the accumulation dtype, cached per device.  ``salt`` separates
    the row probe ``u`` from the column probe ``v``."""
    acc = _acc_dtype(dtype)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    key = (int(n), acc, int(salt), str(dev))
    hit = _vec_cache.get(key)
    if hit is not None:
        return hit
    rng = np.random.default_rng(0xAB5D + int(salt))
    host = rng.choice(np.asarray([-1.0, 1.0]), size=int(n))
    vec = torch.from_numpy(host).to(device=dev, dtype=acc)
    _vec_cache[key] = vec
    if len(_vec_cache) > 64:
        _vec_cache.pop(next(iter(_vec_cache)))
    return vec


def _uv(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, base: Optional[torch.Tensor],
        acc: torch.dtype, peak: bool):
    """``u · (x - base) · v`` per block of ``x`` (base None: zero), and
    with ``peak`` max |x| (else None), a bounded chunk of blocks at a
    time."""
    per = max(1, _CHUNK_BYTES // max(1, x[0].numel() * x.element_size())) if len(x) else 1
    parts, top = [], torch.zeros((), dtype=acc, device=x.device) if peak else None
    for s0 in range(0, x.shape[0], per):
        d = x[s0: s0 + per].to(acc)
        if peak:
            lo, hi = torch.aminmax(d)  # one reduction, no |d| temporary
            top = torch.maximum(top, torch.maximum(-lo, hi))
        if base is not None:
            d = d - base[s0: s0 + per].to(acc)
        parts.append((d @ v) @ u)
    r = torch.cat(parts) if parts else torch.zeros(0, dtype=acc, device=x.device)
    return r, top


def stack_probe(base, out, a_data, b_data, plan, alpha, c_zero: bool = False) -> torch.Tensor:
    """The probe of one executed stack as the device pair ``[err,
    scale]`` (no host sync): ``err`` the largest per-block disagreement
    of the two sides, ``scale`` the magnitude it is relative to.  With
    ``c_zero`` the pristine C is zero, ``base`` is not read, and the
    scale is the absolute-value probe ``|alpha| Σ_s |uᵀA|·|B v|`` per
    block, which bounds the rounding of both sides without reading C
    again (the JAX package's `_stack_probe_err0`); otherwise it is the
    larger of max |right side| and max |C_new| (`_stack_probe_err`)."""
    acc = _acc_dtype(out.dtype)
    nseg, m, n = out.shape
    dev = out.device
    u = probe_vector(m, out.dtype, salt=1, device=dev)
    v = probe_vector(n, out.dtype, device=dev)
    ai, bi = plan.a_idx.long(), plan.b_idx.long()
    ci = torch.repeat_interleave(plan.run_c.long(), (plan.run_ptr[1:] - plan.run_ptr[:-1]).long(),
                                 output_size=plan.entries)  # no host sync for the size
    a_acc, b_acc = a_data.to(acc), b_data.to(acc)
    ua = torch.einsum("amk,m->ak", a_acc, u)
    bv = b_acc @ v
    s = (ua[ai] * bv[bi]).sum(dim=1)
    p = alpha * torch.zeros(nseg, dtype=acc, device=dev).index_add_(0, ci, s)
    r, out_max = _uv(out, u, v, None if c_zero else base, acc, peak=not c_zero)
    err = (r - p).abs().max() if nseg else torch.zeros((), dtype=acc, device=dev)
    if c_zero:
        ua_abs = a_acc.abs().sum(dim=1)  # |u| = 1: uᵀ|A| sums the rows
        bv_abs = b_acc.abs().sum(dim=2)
        s_abs = (ua_abs[ai] * bv_abs[bi]).sum(dim=1)
        scale = abs(alpha) * torch.zeros(nseg, dtype=acc, device=dev).index_add_(0, ci, s_abs).max()
    else:
        scale = torch.maximum(p.abs().max(), out_max) if nseg else out_max
    return torch.stack([err, scale])


def _record_check(driver: str) -> None:
    _metrics.counter("dbcsr_tpu_abft_checks_total",
                     "ABFT probe checksums evaluated, by driver/site").inc(driver=driver)


def record_mismatch(driver: str, site: str, **detail) -> None:
    """Count and publish one probe mismatch without raising."""
    _metrics.counter(
        "dbcsr_tpu_abft_mismatches_total",
        "ABFT probe checksums that disagreed beyond tolerance (silent data "
        "corruption detected), by driver/site",
    ).inc(driver=driver)
    _events.publish("abft_mismatch", dict(detail, driver=driver, site=site), flight=True)


def _mismatch(driver: str, err: float, tol: float, scale: float, shape, site: str) -> None:
    shape_s = "x".join(str(x) for x in shape)
    record_mismatch(driver, site, rel_err=float(err), tolerance=float(tol),
                    scale=float(scale), shape=shape_s)
    raise AbftMismatchError(
        f"ABFT probe mismatch at {site} (driver {driver!r}, shape {shape_s}): relative "
        f"error {err:.3e} > tolerance {tol:.3e} -- finite silent data corruption")


def record_recovery(driver: str) -> None:
    """Count one re-execution that replaced a condemned result (stack
    failover, canvas-to-stack failover, chain rollback recompute)."""
    _metrics.counter(
        "dbcsr_tpu_abft_recoveries_total",
        "SDC-condemned results successfully recomputed and accepted, by driver/site",
    ).inc(driver=driver)
    _events.publish("abft_recovery", {"driver": driver}, flight=True)


def _check_scalars(err: float, scale: float, *, dtype: str, k: int, depth: int,
                   driver: str, shape, site: str) -> None:
    tol = _costmodel.abft_tolerance(dtype, k, depth)
    if not np.isfinite(err) or err > tol * max(scale, 1e-30):
        _mismatch(driver, err / max(scale, 1e-30), tol, scale, shape, site)


# -------------------------------------------------------- deferred checks
_tls = threading.local()


def _pending_list() -> list:
    lst = getattr(_tls, "pending", None)
    if lst is None:
        lst = _tls.pending = []
    return lst


def pending_count() -> int:
    return len(_pending_list())


def discard_pending() -> None:
    """Drop this thread's queued probes, so an aborted product's probes
    are never charged to the next one."""
    _pending_list().clear()


def flush() -> None:
    """Evaluate every probe this thread deferred, with one host sync.
    Each mismatch is counted and published; then the first one is raised
    again with ``.driver``, ``.shape_key`` and ``.mismatch_drivers`` (one
    driver per mismatched launch) attached, so the caller feeds the
    breakers and redoes the product."""
    pend = _pending_list()
    if not pend:
        return
    items, pend[:] = list(pend), []
    pairs = torch.stack([es.to(torch.float64) for es, _, _ in items]).cpu().numpy()
    first: Optional[AbftMismatchError] = None
    drivers: list = []
    for (_, meta, shape_key), (err, scale) in zip(items, pairs):
        try:
            _check_scalars(float(err), float(scale), **meta)
        except AbftMismatchError as exc:
            exc.driver = meta["driver"]
            exc.shape_key = shape_key
            drivers.append(meta["driver"])
            if first is None:
                first = exc
    if first is not None:
        first.mismatch_drivers = drivers
        raise first


# ----------------------------------------------------------- the checks
def check_stack(base, out, a_data, b_data, plan, alpha, c_zero: bool = False,
                defer: bool = False, shape_key=None) -> None:
    """Probe one executed stack plan: ``base`` is the C bin the launch
    started from (not read under ``c_zero``, where it is zero and may be
    None), ``out`` its result.  Raises `AbftMismatchError` on a
    disagreement, at once or, with ``defer``, at the caller's `flush`."""
    if base is None and not c_zero:
        return
    nseg, m, n = out.shape
    k = a_data.shape[2]
    _record_check(plan.label)
    es = stack_probe(base, out, a_data, b_data, plan, alpha, c_zero=c_zero)
    # the double-sided probe folds the u (length-m) contraction into every
    # compared scalar: the accumulation depth widens by max(m, n)
    meta = dict(dtype=name_of(out.dtype), k=k, depth=max(plan.max_run, 1) * max(m, n),
                driver=plan.label, shape=(m, n, k), site="stack")
    if defer:
        _pending_list().append((es, meta, shape_key))
        return
    err, scale = es.tolist()
    _check_scalars(err, scale, **meta)


def check_dense_canvas(cd, ad, bd, c_old, alpha, beta, *, dtype: torch.dtype,
                       driver: str = "dense") -> None:
    """Probe a dense product canvas: ``cd`` must equal ``alpha * ad @ bd +
    beta * c_old`` (``c_old`` None when beta is 0 or C was empty),
    through ``cd·v == alpha * ad@(bd·v) + beta * c_old·v``; one host
    sync.  A mismatch raises, and `mm.multiply` redoes the product on
    the stack format."""
    acc = _acc_dtype(dtype)
    n, k = int(cd.shape[1]), int(ad.shape[1])
    _record_check(driver)
    v = probe_vector(n, dtype, device=cd.device)
    lhs = cd.to(acc) @ v
    rhs = alpha * (ad.to(acc) @ (bd.to(acc) @ v))
    if c_old is not None:
        rhs = rhs + beta * (c_old.to(acc) @ v)
    err, scale = torch.stack([(lhs - rhs).abs().max(),
                              torch.maximum(lhs.abs().max(), rhs.abs().max())]).tolist()
    tol = _costmodel.abft_tolerance(name_of(dtype), k, 4)
    if not np.isfinite(err) or err > tol * max(scale, 1e-30):
        _mismatch(driver, err / max(scale, 1e-30), tol, scale, (cd.shape[0], n, k), "dense")


def check_dense_canvas_batched(pd, ad, bd, *, dtype: torch.dtype,
                               driver: str = "composite") -> None:
    """Probe the composite format's batched product: ``pd[g]`` must equal
    ``ad[g] @ bd[g]`` for every panel g, reduced to the worst panel with
    one host sync."""
    acc = _acc_dtype(dtype)
    n, k = int(pd.shape[2]), int(ad.shape[2])
    _record_check(driver)
    v = probe_vector(n, dtype, device=pd.device)
    lhs = pd.to(acc) @ v
    rhs = torch.bmm(ad.to(acc), (bd.to(acc) @ v).unsqueeze(2)).squeeze(2)
    err, scale = torch.stack([(lhs - rhs).abs().max(),
                              torch.maximum(lhs.abs().max(), rhs.abs().max())]).tolist()
    tol = _costmodel.abft_tolerance(name_of(dtype), k, 4)
    if not np.isfinite(err) or err > tol * max(scale, 1e-30):
        _mismatch(driver, err / max(scale, 1e-30), tol, scale,
                  (int(pd.shape[0]), int(pd.shape[1]), n, k), "dense")
