"""Per-request cost attribution and tenant usage metering.

Counterpart of `dbcsr_tpu/obs/attribution.py`.  A caller that runs
requests (the serving plane, once the port has one) brackets every
execution in a window: `begin_window()` snapshots the summed
`core.stats` driver rollup (seconds, flops, modeled bytes) and the
mempool's H2D/D2H and high-water meters; `bill_window()` attributes the
delta to the window's requests.

The books balance exactly: seconds are billed in integer nanoseconds,
flops and bytes as integers, split by largest-remainder apportionment
(`_split_int`), so the per-member shares sum to the window's total and
the per-tenant sums reproduce the grand total in any order; each
request id is counted once at its terminal state (`on_terminal`).  The
seconds are the rollup's: device seconds under
``DBCSR_TPU_TORCH_SYNC_TIMING=1``, dispatch seconds on the card
otherwise (the JAX package's are device seconds).  An injected fault at
the ``attribution`` site is observable but never unbalances the books.

Surfaces: ``dbcsr_tpu_tenant_{device_seconds,flops,bytes_moved,
saved_flops}_total{tenant}``, `request_info()`, `usage()` and
`conservation()`.  Bounded: the ledger keeps the last
``DBCSR_TPU_TORCH_ATTRIBUTION_N`` (1024) requests and the rollup
``DBCSR_TPU_TORCH_ATTRIBUTION_TENANTS`` (512) tenants, older ones folded
into ``(evicted)``.  ``DBCSR_TPU_TORCH_ATTRIBUTION=0`` turns every hook
into an early return.  Stdlib-only: `core.stats` and `core.mempool` are
read through ``sys.modules``.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time

from dbcsr_tpu_torch.utils import lockcheck as _lockcheck

_lock = _lockcheck.wrap("obs.attribution", threading.Lock())

# ledger phase names, in critical-path order
PHASES = ("queued", "coalesce_wait", "execute", "carve", "serialize")

EVICTED = "(evicted)"

_ledger: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
_tenants: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
# least-recently-active tenant rows fold here when the cap is hit, so
# grand totals (and the conservation invariant) survive eviction
_evicted: dict = {}
_grand = {"device_ns": 0, "flops": 0, "bytes_moved": 0, "pool_bytes": 0,
          "saved_flops": 0, "saved_device_ns": 0, "requests": 0,
          "cache_hits": 0, "windows": 0}
# summed stats-rollup totals at the last reset(): `conservation()`
# compares the grand ledger against (live rollup - baseline)
_baseline = (0.0, 0, 0, 0)


def enabled() -> bool:
    return os.environ.get("DBCSR_TPU_TORCH_ATTRIBUTION", "1") != "0"


def _ledger_cap() -> int:
    try:
        return max(16, int(os.environ.get("DBCSR_TPU_TORCH_ATTRIBUTION_N",
                                          "1024")))
    except ValueError:
        return 1024


def _tenant_cap() -> int:
    try:
        return max(4, int(os.environ.get("DBCSR_TPU_TORCH_ATTRIBUTION_TENANTS",
                                         "512")))
    except ValueError:
        return 512


def _zero_row() -> dict:
    return {"device_ns": 0, "flops": 0, "bytes_moved": 0, "pool_bytes": 0,
            "saved_flops": 0, "saved_device_ns": 0, "requests": 0,
            "cache_hits": 0}


# ------------------------------------------------------------ snapshots

def _rollup_totals() -> tuple:
    """(seconds, flops, bytes_moved, pool_high_water) summed over the
    engine's attribution layers right now.  ``bytes_moved`` folds the
    modeled HBM bytes of the driver rollup with the measured H2D/D2H
    staging meters — every byte the engine accounts anywhere.  Read
    through ``sys.modules``: a layer that was never imported reads 0."""
    seconds = 0.0
    flops = nbytes = 0
    h2d = d2h = hw = 0
    st = sys.modules.get("dbcsr_tpu_torch.core.stats")
    if st is not None:
        for a in st._driver_agg.values():
            seconds += a.seconds
            flops += a.flops
            nbytes += a.nbytes
    mp = sys.modules.get("dbcsr_tpu_torch.core.mempool")
    if mp is not None:
        s = mp._stats  # plain dict reads (GIL-atomic); worker-local use
        h2d = s["h2d_bytes"]
        d2h = s["d2h_bytes"]
        hw = s["high_water"]
    return (seconds, flops, nbytes + h2d + d2h, hw)


def _split_int(total: int, weights: list) -> list:
    """Largest-remainder apportionment: non-negative integer shares
    proportional to ``weights`` that sum EXACTLY to ``total``."""
    n = len(weights)
    wsum = sum(weights)
    if wsum <= 0:
        weights = [1] * n
        wsum = n
    shares = [total * w // wsum for w in weights]
    rem = total - sum(shares)
    # distribute the remainder by descending fractional part (stable)
    order = sorted(range(n),
                   key=lambda i: (total * weights[i]) % wsum, reverse=True)
    for i in range(rem):
        shares[order[i % n]] += 1
    return shares


# --------------------------------------------------------------- ledger

def _new_rec(request_id: str, tenant: str, op: str) -> dict:
    return {
        "request_id": request_id, "tenant": tenant, "op": op,
        "t_submit": time.time(),
        "phases": {},           # seconds per PHASES name
        "billed": {"device_ns": 0, "flops": 0, "bytes_moved": 0,
                   "pool_bytes": 0},
        "saved": {"flops": 0, "device_ns": 0},
        "cached": 0, "windows": 0, "resubmits": 0,
        "terminal": None, "counted": False,
    }


def _rec_locked(request_id: str, tenant: str, op: str) -> dict:
    rec = _ledger.get(request_id)
    if rec is None:
        rec = _ledger[request_id] = _new_rec(request_id, tenant, op)
        cap = _ledger_cap()
        while len(_ledger) > cap:
            _ledger.popitem(last=False)
    return rec


def _tenant_locked(name: str) -> dict:
    row = _tenants.get(name)
    if row is None:
        row = _tenants[name] = _zero_row()
        cap = _tenant_cap()
        while len(_tenants) > cap:
            _, old = _tenants.popitem(last=False)
            if not _evicted:
                _evicted.update(_zero_row())
            for k, v in old.items():
                _evicted[k] += v
    else:
        _tenants.move_to_end(name)
    return row


def on_submit(req) -> None:
    """Open (or re-arm) the ledger row for a submitted request.  A
    journal-replayed resubmission carries the SAME request id: its row
    re-arms — terminal cleared, billed totals kept — so the replay's
    cost lands on the same logical request and the terminal guard
    cannot swallow the replay's real completion."""
    if not enabled():
        return
    with _lock:
        rec = _ledger.get(req.request_id)
        if rec is None:
            _rec_locked(req.request_id, req.tenant, req.op)
        else:
            rec["resubmits"] += 1
            rec["terminal"] = None
            _ledger.move_to_end(req.request_id)


def phase(request_id: str, name: str, seconds: float) -> None:
    """Accumulate wall seconds into one critical-path phase of the
    request's ledger row (no-op for unknown ids — e.g. bare
    `AdmissionQueue` use outside the engine)."""
    if not enabled() or seconds <= 0:
        return
    with _lock:
        rec = _ledger.get(request_id)
        if rec is not None:
            rec["phases"][name] = rec["phases"].get(name, 0.0) + seconds


def group_phase(requests: list, name: str, seconds: float) -> None:
    """Record one group-level phase duration (e.g. the composite
    carve) on every member's ledger row — the group shares the wall
    interval, so each member sees the full duration."""
    if not enabled() or seconds <= 0:
        return
    with _lock:
        for r in requests:
            rec = _ledger.get(r.request_id)
            if rec is not None:
                rec["phases"][name] = (rec["phases"].get(name, 0.0)
                                       + seconds)


def on_terminal(req, state: str) -> None:
    """Terminal chokepoint (called from `Request._finish`): stamp the
    final state ONCE per armed request id — repeats (a replayed fail
    path re-finishing, defensive double-_finish) are ignored, so a
    request is never counted twice."""
    if not enabled():
        return
    with _lock:
        rec = _ledger.get(req.request_id)
        if rec is None or rec["terminal"] is not None:
            return
        rec["terminal"] = state
        if not rec["counted"]:
            rec["counted"] = True
            _tenant_locked(rec["tenant"])["requests"] += 1
            _grand["requests"] += 1


# -------------------------------------------------------------- billing

def begin_window() -> tuple | None:
    """Open a billing window around one worker execution (a coalesced
    composite, one serialized request, a cache-hit service).  Returns
    the opaque token `bill_window` consumes, or None when attribution
    is off."""
    if not enabled():
        return None
    return (time.perf_counter(),) + _rollup_totals()


def bill_window(token, requests: list, weights=None,
                phase_name: str = "execute") -> None:
    """Close a billing window: attribute the engine-rollup delta since
    ``token`` to ``requests``, split by ``weights`` (the coalesced
    group's per-request FLOP shares; equal split when absent — e.g. a
    failed composite whose per-request shares never materialized).
    Shares sum EXACTLY to the measured delta (`_split_int`).  The
    window's wall time lands in phase ``phase_name`` ("execute", or
    "serialize" for a degrade replay's serialized re-execution)."""
    if token is None or not requests:
        return
    wall = time.perf_counter() - token[0]
    cur = _rollup_totals()
    dev_ns = int(round(max(0.0, cur[0] - token[1]) * 1e9))
    flops = max(0, cur[1] - token[2])
    nbytes = max(0, cur[2] - token[3])
    pool = max(0, cur[3] - token[4])
    # chaos handle on the billing path: an injected fault here must be
    # observable (bus event + counter via the faults layer) but can
    # never unbalance the books or fail the request — attribution is
    # bookkeeping, not execution
    fa = sys.modules.get("dbcsr_tpu_torch.resilience.faults")
    if fa is not None and fa.active():
        try:
            fa.maybe_inject("attribution", requests=str(len(requests)),
                            request_id=requests[0].request_id)
        except Exception:
            pass  # billing below still runs: the books stay balanced
    n = len(requests)
    if weights is None or len(weights) != n:
        weights = [1] * n
    weights = [max(0, int(w)) for w in weights]
    ns_sh = _split_int(dev_ns, weights)
    fl_sh = _split_int(flops, weights)
    by_sh = _split_int(nbytes, weights)
    po_sh = _split_int(pool, weights)
    with _lock:
        _grand["windows"] += 1
        _grand["device_ns"] += dev_ns
        _grand["flops"] += flops
        _grand["bytes_moved"] += nbytes
        _grand["pool_bytes"] += pool
        for i, r in enumerate(requests):
            rec = _rec_locked(r.request_id, r.tenant, r.op)
            rec["windows"] += 1
            rec["billed"]["device_ns"] += ns_sh[i]
            rec["billed"]["flops"] += fl_sh[i]
            rec["billed"]["bytes_moved"] += by_sh[i]
            rec["billed"]["pool_bytes"] += po_sh[i]
            rec["phases"][phase_name] = (
                rec["phases"].get(phase_name, 0.0) + wall)
            row = _tenant_locked(r.tenant)
            row["device_ns"] += ns_sh[i]
            row["flops"] += fl_sh[i]
            row["bytes_moved"] += by_sh[i]
            row["pool_bytes"] += po_sh[i]
            _meter(r.tenant, ns_sh[i], fl_sh[i], by_sh[i], 0)


def credit_saved(req, flops: int, seconds: float = 0.0) -> None:
    """Record a value-reuse credit: a product-cache (or incremental)
    hit served this request without dispatching — bill nothing, credit
    the tenant with the device work the hit avoided."""
    if not enabled():
        return
    flops = max(0, int(flops))
    ns = int(round(max(0.0, seconds) * 1e9))
    with _lock:
        rec = _rec_locked(req.request_id, req.tenant, req.op)
        rec["cached"] += 1
        rec["saved"]["flops"] += flops
        rec["saved"]["device_ns"] += ns
        row = _tenant_locked(req.tenant)
        row["saved_flops"] += flops
        row["saved_device_ns"] += ns
        row["cache_hits"] += 1
        _grand["saved_flops"] += flops
        _grand["saved_device_ns"] += ns
        _grand["cache_hits"] += 1
        _meter(req.tenant, 0, 0, 0, flops)


def _meter(tenant: str, dev_ns: int, flops: int, nbytes: int,
           saved_flops: int) -> None:
    """Mirror one billing into the Prometheus tenant meters (scraped
    by /metrics and replayed from telemetry shards via the timeseries
    collector).  Called with the attribution lock held; the registry
    has its own lock and never calls back into this module."""
    from dbcsr_tpu_torch.obs import metrics as _metrics

    if dev_ns:
        _metrics.counter(
            "dbcsr_tpu_tenant_device_seconds_total",
            "device dispatch-seconds attributed to the owning tenant "
            "(exact split of the engine rollup; ns-quantized)",
        ).inc(dev_ns / 1e9, tenant=tenant)
    if flops:
        _metrics.counter(
            "dbcsr_tpu_tenant_flops_total",
            "true flops attributed to the owning tenant",
        ).inc(flops, tenant=tenant)
    if nbytes:
        _metrics.counter(
            "dbcsr_tpu_tenant_bytes_moved_total",
            "bytes moved (modeled HBM + measured H2D/D2H) attributed "
            "to the owning tenant",
        ).inc(nbytes, tenant=tenant)
    if saved_flops:
        _metrics.counter(
            "dbcsr_tpu_tenant_saved_flops_total",
            "flops a tenant's requests did NOT dispatch thanks to "
            "product-cache / value-reuse hits (the saved credit)",
        ).inc(saved_flops, tenant=tenant)


# -------------------------------------------------------------- readers

def _row_view(row: dict) -> dict:
    out = dict(row)
    out["device_seconds"] = row["device_ns"] / 1e9
    out["saved_device_seconds"] = row["saved_device_ns"] / 1e9
    return out


def request_info(request_id: str) -> dict | None:
    """JSON-safe ledger row for `/serve/status?request_id=` — the
    per-request critical-path phase breakdown plus billed totals."""
    with _lock:
        rec = _ledger.get(request_id)
        if rec is None:
            return None
        return {
            "request_id": rec["request_id"],
            "tenant": rec["tenant"],
            "op": rec["op"],
            "phases_ms": {k: round(v * 1e3, 3)
                          for k, v in rec["phases"].items()},
            "billed": {
                "device_seconds": rec["billed"]["device_ns"] / 1e9,
                "flops": rec["billed"]["flops"],
                "bytes_moved": rec["billed"]["bytes_moved"],
                "pool_bytes": rec["billed"]["pool_bytes"],
            },
            "saved": {"flops": rec["saved"]["flops"],
                      "device_seconds": rec["saved"]["device_ns"] / 1e9},
            "cached": rec["cached"],
            "windows": rec["windows"],
            "resubmits": rec["resubmits"],
            "terminal": rec["terminal"],
        }


def usage(top: int = 5) -> dict:
    """Per-tenant usage rollup + top consumers (the `/usage` endpoint,
    the JAX package's doctor and usage report read this
    shape)."""
    with _lock:
        tenants = {t: _row_view(row) for t, row in _tenants.items()}
        if _evicted:
            tenants[EVICTED] = _row_view(_evicted)
        totals = dict(_grand)
    totals["device_seconds"] = totals["device_ns"] / 1e9
    totals["saved_device_seconds"] = totals["saved_device_ns"] / 1e9
    ranked = sorted(tenants.items(),
                    key=lambda kv: kv[1]["device_ns"], reverse=True)
    return {
        "tenants": tenants,
        "top": [{"tenant": t,
                 "device_seconds": row["device_seconds"],
                 "flops": row["flops"],
                 "requests": row["requests"]}
                for t, row in ranked[:max(0, top)]],
        "totals": totals,
    }


def conservation() -> dict:
    """Both sides of the hard invariant, machine-readable:

    * ``tenant_sum`` — per-tenant billings summed (evicted fold
      included): MUST equal ``grand`` exactly (integers).
    * ``rollup`` — the live `core.stats`/mempool totals minus the
      baseline taken at the last `reset()`: ``grand`` flops/bytes MUST
      equal it exactly; device seconds match to the per-window ns
      quantization (``grand["windows"]`` nanoseconds at most) PLUS
      whatever the process executed OUTSIDE serve billing windows —
      the serve-only conservation tests keep that at zero.
    """
    with _lock:
        tenant_sum = _zero_row()
        rows = list(_tenants.values()) + ([_evicted] if _evicted else [])
        for row in rows:
            for k in tenant_sum:
                tenant_sum[k] += row[k]
        grand = dict(_grand)
    cur = _rollup_totals()
    return {
        "tenant_sum": tenant_sum,
        "grand": grand,
        "rollup": {
            "device_seconds": cur[0] - _baseline[0],
            "flops": cur[1] - _baseline[1],
            "bytes_moved": cur[2] - _baseline[2],
        },
    }


def ledger_size() -> int:
    with _lock:
        return len(_ledger)


def tenant_rows() -> int:
    with _lock:
        return len(_tenants)


def reset() -> None:
    """Clear the ledger, tenant rollups and grand totals, and
    re-baseline against the (freshly reset) engine rollup.  Wired into
    `metrics.reset(include_stats=True)` — same contract as the
    roofline and pool layers."""
    global _baseline
    with _lock:
        _ledger.clear()
        _tenants.clear()
        _evicted.clear()
        for k in _grand:
            _grand[k] = 0
        _baseline = _rollup_totals()
