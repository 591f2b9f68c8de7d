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
and composite formats' canvases; `matrix_probe` and `verify_product`
probe a whole product (the incremental multiply's splice,
`mm/incremental.py`).  A launch run at a demoted compute dtype
(`acc/precision.py`) is held to its demotion ceiling
(`obs.costmodel.demoted_abft_tolerance`): a breach promotes its cells to
native and raises `PrecisionExceededError`, which `acc.smm` answers with
a native re-execution, never as corruption; a pass records the residual
for the cell.  Complex stacks are probed alike (complex probe sums, real
errors).  `check_superstack` probes a fused C-bin launch
(`acc.smm.execute_superstack`) with one delta probe for the whole bin.
`tree_probe` and `shift_conserved` probe the grid engines' panel
shifts (`parallel/overlap.run_ticks`): a shift permutes panels without
changing them, so the panels' absolute sum is conserved across it.

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
from dbcsr_tpu_torch.core.kinds import name_of, real_dtype_of
from dbcsr_tpu_torch.obs import costmodel as _costmodel
from dbcsr_tpu_torch.obs import events as _events
from dbcsr_tpu_torch.obs import metrics as _metrics

# the probe's left side reads C a bounded chunk of blocks at a time
_CHUNK_BYTES = 256 * 1024 * 1024


class AbftMismatchError(RuntimeError):
    """A probe checksum disagreed beyond tolerance: the launch produced a
    wrong, possibly finite, answer.  Classified "sdc" by
    `acc.smm._classify_failure`."""


class PrecisionExceededError(AbftMismatchError):
    """A demoted launch's probe residual breached its demotion ceiling:
    the adaptive planner's promote signal, not corruption.
    `acc.smm.execute_stack` answers it by re-executing natively (the
    cells were promoted as it was raised).  A subclass of
    `AbftMismatchError`, so a layer that does not know it still rejects
    the result."""


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
    real = real_dtype_of(acc)
    parts, top = [], torch.zeros((), dtype=real, device=x.device) if peak else None
    for s0 in range(0, x.shape[0], per):
        d = x[s0: s0 + per].to(acc)
        if peak and d.is_complex():
            top = torch.maximum(top, d.abs().max())
        elif peak:
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
    p, ai, bi, ci = _span_probe(a_data, b_data, plan, u, v, alpha, nseg)
    r, out_max = _uv(out, u, v, None if c_zero else base, acc, peak=not c_zero)
    err = (r - p).abs().max() if nseg else torch.zeros((), dtype=acc, device=dev)
    if c_zero:
        ua_abs = a_data.to(acc).abs().sum(dim=1)  # |u| = 1: uᵀ|A| sums the rows
        bv_abs = b_data.to(acc).abs().sum(dim=2)
        s_abs = (ua_abs[ai] * bv_abs[bi]).sum(dim=1)
        scale = abs(alpha) * torch.zeros(nseg, dtype=s_abs.dtype,
                                         device=dev).index_add_(0, ci, s_abs).max()
    else:
        scale = torch.maximum(p.abs().max(), out_max) if nseg else out_max
    return torch.stack([err, scale])


def _span_probe(a_data, b_data, plan, u, v, alpha, nseg: int):
    """The right side of one stack's probe, ``alpha * Σ_s (uᵀA)[ai_s] ·
    (B v)[bi_s]`` per C block, with the stack's index arrays (ai, bi,
    ci) as long tensors."""
    acc = u.dtype
    ai, bi = plan.a_idx.long(), plan.b_idx.long()
    ci = torch.repeat_interleave(plan.run_c.long(), (plan.run_ptr[1:] - plan.run_ptr[:-1]).long(),
                                 output_size=plan.entries)  # no host sync for the size
    ua = torch.einsum("amk,m->ak", a_data.to(acc), u)
    bv = b_data.to(acc) @ v
    s = (ua[ai] * bv[bi]).sum(dim=1)
    p = alpha * torch.zeros(nseg, dtype=acc, device=u.device).index_add_(0, ci, s)
    return p, ai, bi, ci


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
                   driver: str, shape, site: str, prec=None, cells=None) -> None:
    """Hold one probe's ``[err, scale]`` to its tolerance.  ``prec`` and
    ``cells`` mark a demoted launch (its spec and its (m, n, k, dtype)
    cells): its ceiling is the demotion tolerance, a breach promotes the
    cells and raises `PrecisionExceededError`, and a pass records the
    residual (ref `dbcsr_tpu/acc/abft.py:283-320`)."""
    from dbcsr_tpu_torch.acc import precision as _precision

    if prec is not None:
        tol = _costmodel.demoted_abft_tolerance(dtype, prec[0], prec[1], k, depth)
    else:
        tol = _costmodel.abft_tolerance(dtype, k, depth)
    rel = err / max(scale, 1e-30)
    if not np.isfinite(err) or err > tol * max(scale, 1e-30):
        if prec is not None:
            _precision.note_exceeded(cells, rel, tol)
            raise PrecisionExceededError(
                f"demoted-precision probe residual at {site} (driver {driver!r}, shape "
                f"{'x'.join(str(x) for x in shape)}, compute {prec[0]}"
                f"{'+comp' if prec[1] else ''}): relative error {rel:.3e} > demotion "
                f"ceiling {tol:.3e} -- cells promoted to native")
        _mismatch(driver, rel, tol, scale, shape, site)
    elif prec is not None and cells:
        _precision.note_probe_ok(cells, rel)


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
    breakers and redoes the product.  A demoted launch's breach
    (`PrecisionExceededError`) stays out of the mismatch accounting and
    is raised only when no corruption was found: the caller's redo
    re-executes natively (ref `dbcsr_tpu/acc/abft.py:340-392`)."""
    pend = _pending_list()
    if not pend:
        return
    items, pend[:] = list(pend), []
    pairs = torch.stack([es.to(torch.float64) for es, _, _ in items]).cpu().numpy()
    first: Optional[AbftMismatchError] = None
    first_prec: Optional[PrecisionExceededError] = None
    drivers: list = []
    for (_, meta, shape_key), (err, scale) in zip(items, pairs):
        try:
            _check_scalars(float(err), float(scale), **meta)
        except PrecisionExceededError as exc:
            exc.driver = meta["driver"]
            exc.shape_key = shape_key
            if first_prec is None:
                first_prec = exc
        except AbftMismatchError as exc:
            exc.driver = meta["driver"]
            exc.shape_key = shape_key
            drivers.append(meta["driver"])
            if first is None:
                first = exc
    if first is not None:
        first.mismatch_drivers = drivers
        raise first
    if first_prec is not None:
        raise first_prec


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
    prec = plan.precision
    meta = dict(dtype=name_of(out.dtype), k=k, depth=max(plan.max_run, 1) * max(m, n),
                driver=plan.label, shape=(m, n, k), site="stack", prec=prec,
                cells=[(m, n, k, name_of(out.dtype))] if prec is not None else None)
    if defer:
        _pending_list().append((es, meta, shape_key))
        return
    err, scale = es.tolist()
    _check_scalars(err, scale, **meta)


def check_superstack(base, out, a_datas, b_datas, splan, alpha, c_zero: bool = False,
                     defer: bool = False, shape_key=None) -> None:
    """Probe one fused C-bin launch with one delta probe: the left side
    ``u · (C_new - C_old) · v`` per C block, the right side the sum of
    every span's (ref `dbcsr_tpu/acc/abft.py:447`).  Under ``c_zero``
    the pristine bin is zero and ``base`` is not read.  The scale is the
    larger of max |right side| and max |C_new|; the accumulation depth
    sums the spans' longest runs."""
    if base is None and not c_zero:
        return
    nseg, m, n = out.shape
    acc = _acc_dtype(out.dtype)
    dev = out.device
    u = probe_vector(m, out.dtype, salt=1, device=dev)
    v = probe_vector(n, out.dtype, device=dev)
    r, out_max = _uv(out, u, v, None if c_zero else base, acc, peak=True)
    p = torch.zeros(nseg, dtype=acc, device=dev)
    k_max = depth = 1
    for plan, a_d, b_d in zip(splan.plans, a_datas, b_datas):
        p = p + _span_probe(a_d, b_d, plan, u, v, alpha, nseg)[0]
        k_max = max(k_max, a_d.shape[2])
        depth += max(plan.max_run, 1)
    _record_check("fused")
    err = (r - p).abs().max() if nseg else torch.zeros((), dtype=out_max.dtype, device=dev)
    es = torch.stack([err, torch.maximum(p.abs().max(), out_max) if nseg else out_max])
    meta = dict(dtype=name_of(out.dtype), k=k_max, depth=depth * max(m, n), driver="fused",
                shape=(m, n, len(splan.plans)), site="superstack", prec=None, cells=None)
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


# ------------------------------------------------------ whole-matrix probes
def matrix_probe(m, v: torch.Tensor) -> torch.Tensor:
    """``M @ v`` as a device vector of length ``m.nfullrows`` (``v`` has
    ``m.nfullcols``), one block mat-vec and row scatter-add per bin (ref
    `dbcsr_tpu/acc/abft.py:613-650`); a symmetric kind probes as stored
    (the callers desymmetrize first)."""
    from dbcsr_tpu_torch.core.matrix import to_index

    acc = _acc_dtype(m.dtype)
    out = torch.zeros(m.nfullrows, dtype=acc, device=m.device)
    if m.nblks == 0:
        return out
    rows, cols = m.entry_coords()
    roff, coff = m.row_blk_offsets[rows], m.col_blk_offsets[cols]
    v = v.to(acc)
    for b_id, b in enumerate(m.bins):
        if b.count == 0:
            continue
        sel = np.nonzero(m.ent_bin == b_id)[0]
        ro = np.empty(b.count, np.int64)
        co = np.empty(b.count, np.int64)
        ro[m.ent_slot[sel]] = roff[sel]
        co[m.ent_slot[sel]] = coff[sel]
        bm, bn = b.shape
        vseg = v[to_index(co, m.device)[:, None] + torch.arange(bn, device=m.device)[None, :]]
        prod = torch.einsum("sij,sj->si", b.data.to(acc), vseg)
        idx = to_index(ro, m.device)[:, None] + torch.arange(bm, device=m.device)[None, :]
        out.index_add_(0, idx.reshape(-1), prod.reshape(-1))
    return out


def product_probeable(params: dict) -> bool:
    """Whether a product admits the whole-product probe identity: no
    value-dependent filter, no pattern lock, plain "N" operands."""
    return (params.get("filter_eps") is None and not params.get("retain_sparsity")
            and str(params.get("transa", "N")).upper() == "N"
            and str(params.get("transb", "N")).upper() == "N")


def verify_product(a, b, c, alpha, beta, r_old: Optional[torch.Tensor], *,
                   request_id: str = "", driver: str = "serve", site: str = "serve_execute",
                   precisions=()) -> None:
    """Probe a completed product ``C = alpha A B + beta C_old`` through
    ``C·v == alpha A·(B·v) + beta (C_old·v)``; ``r_old`` is C_old's probe
    (None for beta = 0).  ``precisions``: the demoted specs any of C's
    blocks were computed at, whose ceilings (at A's widest block
    column) the tolerance widens to.  Raises `AbftMismatchError` on a
    disagreement (ref `dbcsr_tpu/acc/abft.py:666-704`)."""
    k = a.nfullcols
    _record_check(driver)
    v = probe_vector(c.nfullcols, c.dtype, device=c.device)
    r_c = matrix_probe(c, v)
    rhs = alpha * matrix_probe(a, matrix_probe(b, v))
    if r_old is not None:
        rhs = rhs + beta * r_old
    err, scale = torch.stack([(r_c - rhs).abs().max(),
                              torch.maximum(r_c.abs().max(), rhs.abs().max())]).tolist()
    depth = max(a.nblkcols, 1) * 4
    tol = _costmodel.abft_tolerance(name_of(c.dtype), k, depth)
    kb = int(np.max(a.col_blk_sizes)) if a.nblkcols else 1
    for spec in precisions:
        tol = max(tol, _costmodel.demoted_abft_tolerance(name_of(c.dtype), *spec, kb, depth))
    if not np.isfinite(err) or err > tol * max(scale, 1e-30):
        rel = err / max(scale, 1e-30)
        record_mismatch(driver, site, rel_err=rel, tolerance=tol, request_id=request_id,
                        shape=f"{c.nfullrows}x{c.nfullcols}x{k}")
        raise AbftMismatchError(f"ABFT probe mismatch on product {request_id or '?'}: "
                                f"relative error {rel:.3e} > {tol:.3e}")


# ------------------------------------------- distributed tick probes
def tree_probe(tensors) -> float:
    """Permutation-invariant probe of a list of tensors: the sum of their
    absolute values in the accumulation dtype.  A shift permutes panels
    without changing them, so the probe is conserved across every shift
    of the tick pipelines, up to resummation rounding (`shift_conserved`)."""
    total = 0.0
    for t in tensors:
        if t is None or not (t.is_floating_point() or t.is_complex()):
            continue
        total += float(t.to(_acc_dtype(t.dtype)).abs().sum())
    return total


def shift_conserved(before: float, after: float, dtype, nelem: int) -> bool:
    """True when a shift's probe survived within the resummation rounding
    of ``nelem`` accumulated terms."""
    tol = _costmodel.abft_tolerance(name_of(dtype), 1, nelem)
    scale = max(abs(before), abs(after), 1e-30)
    if not np.isfinite(after):
        return False
    return abs(after - before) <= tol * scale
