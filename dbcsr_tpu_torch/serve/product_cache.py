"""Content-addressed product cache: identical submissions, no launch.

Counterpart of `dbcsr_tpu/serve/product_cache.py`.  A ``multiply``
request whose (A, B, alpha, trans flags, options, C input pattern)
VALUE digest matches a product served before gets the cached C without
touching the engine: no candidate enumeration, no plan, no launch.
Tenants submitting the same operands share the entry (content
addressing is tenant-blind); bytes are accounted to the inserting
tenant.

Keys are `core.digests.matrix_value_digest`s, memoized on each bin
tensor's identity and ``_version``, so an unchanged matrix re-keys in
O(1) and any change of its values -- a funnel that replaces bins, or a
write in place -- changes the digest and misses; stale entries age out
of the LRU.

A cached C is ALIASED, never copied.  Tensors are mutable here, so the
entry and every C it is installed into share bins under the port's
copy-on-write rule: `store` and `install` mark the C's bins shared
(``_bins_shared``), every in-place writer calls `own_bins` first (and
the multiply gives C fresh bins), so nothing a tenant does to its C
reaches the entry.  Each entry also records its bins' ``_version``s: an
entry whose bins were written all the same is dropped at lookup, never
served.

Eligibility mirrors the ABFT probe's (beta == 0, no value-dependent
filter, no pattern lock, plain 'N' ops, non-symmetric finalized
operands): every cacheable product is probeable, so with ABFT on each
served hit is re-certified against the live A and B before it leaves
the engine.

The fleet tier: each worker serves its entries at ``GET
/serve/cache?digest=`` (`obs.server`), and a local miss asks the peers
named by ``DBCSR_TPU_TORCH_FLEET_PEERS``.  An entry travels as the host
bytes of each bin (base64) and is rebuilt on the receiving worker's
device; aliasing never crosses a process.
"""

from __future__ import annotations

import base64
import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.core import digests
from dbcsr_tpu_torch.core.kinds import dtype_of, name_of
from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY, BlockSparseMatrix
from dbcsr_tpu_torch.utils import lockcheck as _lockcheck

_lock = _lockcheck.wrap("serve.product_cache", threading.Lock())


class _Entry:
    """One cached product: the result's keys and binning, the aliased
    device bins with their versions at store, byte size, inserting
    tenant, and the true flops (and measured seconds) a hit saves."""

    __slots__ = ("keys", "binning", "bins", "versions", "nbytes", "tenant", "flops",
                 "seconds", "hits")

    def __init__(self, c: Optional[BlockSparseMatrix], tenant: str, flops: int,
                 seconds: float = 0.0, *, keys=None, bins=None):
        from dbcsr_tpu_torch.core import mempool

        if c is not None:
            self.keys = c.keys
            self.binning = (c.ent_bin, c.ent_slot, [tuple(b.shape) for b in c.bins])
            self.bins, self.nbytes = mempool.alias_bins(c)
        else:
            # wire path (`entry_from_wire`): bins this process built
            self.keys = keys
            self.binning = None
            self.bins = list(bins or ())
            self.nbytes = sum(d.numel() * d.element_size() for _, d, _ in self.bins)
        self.versions = tuple(d._version for _, d, _ in self.bins)
        self.tenant = tenant
        self.flops = int(flops)
        self.seconds = float(seconds)
        self.hits = 0

    def written(self) -> bool:
        """Whether a bin was written in place since the entry was made."""
        return any(d._version != v for (_, d, _), v in zip(self.bins, self.versions))


_entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
_bytes_total = 0
_bytes_by_tenant: dict = {}
# hex digest -> key, the fleet tier's HTTP handle
_by_digest: dict = {}
# peer url -> monotonic time until which it is skipped (a down peer
# costs one timeout, then lookups stay local until the cool-off ends)
_peer_down: dict = {}


def _counter(result: str, **labels):
    from dbcsr_tpu_torch.obs import metrics as _metrics

    _metrics.counter(
        "dbcsr_tpu_product_cache_total",
        "serve-layer content-addressed product cache outcomes (hit = "
        "request served without an engine dispatch)",
    ).inc(result=result, **labels)


def _bytes_gauges() -> None:
    from dbcsr_tpu_torch.obs import metrics as _metrics

    g = _metrics.gauge(
        "dbcsr_tpu_product_cache_bytes",
        "device bytes pinned by the content-addressed product cache, "
        "accounted to the inserting tenant",
    )
    g.set(_bytes_total)
    for t, v in _bytes_by_tenant.items():
        g.set(v, tenant=t)


def enabled() -> bool:
    from dbcsr_tpu_torch.core.config import get_config

    return bool(get_config().serve_product_cache)


def key_of(params: dict) -> Optional[tuple]:
    """The content-addressed key of one multiply request, or None when
    the request is not value-cacheable (beta != 0, value-dependent
    filtering, pattern locks, limits, symmetric or unfinalized
    operands)."""
    if params.get("filter_eps") is not None or params.get("retain_sparsity"):
        return None
    for lim in ("first_row", "last_row", "first_col", "last_col", "first_k", "last_k",
                "element_limits"):
        if params.get(lim) is not None:
            return None
    try:
        alpha = digests.scalar_key(params.get("alpha", 1.0))
        beta = digests.scalar_key(params.get("beta", 0.0))
    except TypeError:
        return None
    if beta != 0:
        return None
    if str(params.get("transa", "N")).upper() != "N" \
            or str(params.get("transb", "N")).upper() != "N":
        return None
    a, b, c = params.get("a"), params.get("b"), params.get("c")
    for m in (a, b, c):
        if not isinstance(m, BlockSparseMatrix) or not m.valid:
            return None
        if m.matrix_type != NO_SYMMETRY:
            return None
    return (
        alpha,
        digests.matrix_value_digest(a),
        digests.matrix_value_digest(b),
        # beta == 0 makes C's values irrelevant, but its input pattern
        # shapes the result (new keys = union(old, product))
        c.pattern_fingerprint(),
        name_of(c.dtype),
        c.device.type,
    )


def lookup(key: tuple, tenant: str = "?") -> Optional[_Entry]:
    """Fetch an entry (LRU-refreshing); counts only misses -- a hit is
    counted by `note_served` after the engine's ABFT re-certification
    accepted it.  An entry whose bins were written in place is dropped
    and reads as a miss."""
    with _lock:
        ent = _entries.get(key)
        if ent is not None and ent.written():
            _entries.pop(key)
            _by_digest.pop(digest_of_key(key), None)
            _drop_locked(ent)
            _counter("invalidated", tenant=tenant)
            ent = None
        if ent is None:
            _counter("miss", tenant=tenant)
            return None
        _entries.move_to_end(key)
    return ent


def note_served(ent: _Entry, tenant: str = "?") -> None:
    """Account one certified, served hit."""
    from dbcsr_tpu_torch.obs import metrics as _metrics

    ent.hits += 1
    _counter("hit", tenant=tenant)
    _metrics.counter(
        "dbcsr_tpu_product_cache_saved_flops_total",
        "true flops of products served from the content-addressed "
        "cache instead of dispatched",
    ).inc(ent.flops)


def install(ent: _Entry, c: BlockSparseMatrix) -> None:
    """Install a cached result into the request's C: the entry's bins
    are adopted as they are (no copy) and C's bins are marked shared, so
    C's next in-place write gives it bins of its own first."""
    from dbcsr_tpu_torch.core import mempool

    binning = None
    if ent.binning is not None:
        binning = tuple(x.copy() if isinstance(x, np.ndarray) else list(x)
                        for x in ent.binning)
    mempool.adopt_aliased_bins(c, ent.keys, ent.bins, binning=binning)


def store(key: tuple, c: BlockSparseMatrix, tenant: str, flops: int,
          seconds: float = 0.0) -> None:
    """Bank a freshly served product, bounded by the config
    (``serve_product_cache_entries`` / ``_bytes``); eviction is LRU and
    drops references (a bin is freed when its last holder lets go)."""
    global _bytes_total
    from dbcsr_tpu_torch.core.config import get_config

    cfg = get_config()
    ent = _Entry(c, tenant, flops, seconds=seconds)
    if ent.nbytes > cfg.serve_product_cache_bytes:
        return  # cannot fit even alone
    c._bins_shared = True  # the cache aliases these bins now
    with _lock:
        old = _entries.pop(key, None)
        if old is not None:
            _drop_locked(old)
        _entries[key] = ent
        _by_digest[digest_of_key(key)] = key
        _bytes_total += ent.nbytes
        _bytes_by_tenant[tenant] = _bytes_by_tenant.get(tenant, 0) + ent.nbytes
        while _entries and (len(_entries) > cfg.serve_product_cache_entries
                            or _bytes_total > cfg.serve_product_cache_bytes):
            if len(_entries) == 1 and _bytes_total <= cfg.serve_product_cache_bytes:
                break
            ekey, evicted = _entries.popitem(last=False)
            _by_digest.pop(digest_of_key(ekey), None)
            _drop_locked(evicted)
            _counter("evict", tenant=evicted.tenant)
    _counter("store", tenant=tenant)
    _bytes_gauges()


def _drop_locked(ent: _Entry) -> None:
    global _bytes_total
    _bytes_total -= ent.nbytes
    t = ent.tenant
    _bytes_by_tenant[t] = max(0, _bytes_by_tenant.get(t, 0) - ent.nbytes)
    if not _bytes_by_tenant[t]:
        _bytes_by_tenant.pop(t, None)


def invalidate(key: tuple, tenant: str = "?") -> None:
    """Drop one entry (an ABFT probe condemned it on a hit)."""
    with _lock:
        ent = _entries.pop(key, None)
        if ent is not None:
            _by_digest.pop(digest_of_key(key), None)
            _drop_locked(ent)
    if ent is not None:
        _counter("invalidated", tenant=tenant)
        _bytes_gauges()


def clear() -> None:
    """Drop everything (tests, drain)."""
    global _bytes_total
    with _lock:
        _entries.clear()
        _by_digest.clear()
        _peer_down.clear()
        _bytes_total = 0
        _bytes_by_tenant.clear()
    _bytes_gauges()


def snapshot() -> dict:
    """Machine-readable cache state (timeseries, tests)."""
    with _lock:
        return {
            "entries": len(_entries),
            "bytes": _bytes_total,
            "bytes_by_tenant": dict(_bytes_by_tenant),
            "hits": sum(e.hits for e in _entries.values()),
        }


# ------------------------------------------------------ fleet-shared tier

def digest_of_key(key: tuple) -> str:
    """Stable hex handle of a cache key: its repr is deterministic
    across processes, so its sha1 can travel in a URL."""
    return hashlib.sha1(repr(key).encode()).hexdigest()


def _host_bytes(data: torch.Tensor) -> bytes:
    t = data.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)  # numpy has no bfloat16: ship the bits
    return t.numpy().tobytes()


def _from_host_bytes(raw: bytes, dtype: torch.dtype, shape, device) -> torch.Tensor:
    if dtype == torch.bfloat16:
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).to(device)
    arr = np.frombuffer(raw, dtype=torch.empty((), dtype=dtype).numpy().dtype)
    return torch.from_numpy(arr.reshape(shape).copy()).to(device)


def export_entry(digest_hex: str) -> Optional[dict]:
    """The wire form of one cached entry (the ``/serve/cache`` route's
    payload), or None when absent: each bin as the base64 of its host
    bytes."""
    with _lock:
        key = _by_digest.get(digest_hex)
        ent = _entries.get(key) if key is not None else None
        if ent is None or ent.written():
            return None
        _entries.move_to_end(key)
        bins = list(ent.bins)
        keys = ent.keys
        meta = {"tenant": ent.tenant, "flops": ent.flops, "seconds": ent.seconds}
    wire_bins = [{
        "shape": [int(s) for s in data.shape],
        "dtype": name_of(data.dtype),
        "count": int(count),
        "data": base64.b64encode(_host_bytes(data)).decode("ascii"),
    } for _, data, count in bins]
    return dict(meta, digest=digest_hex, keys=np.asarray(keys).tolist(), bins=wire_bins)


def entry_from_wire(payload: dict, device) -> _Entry:
    """Rebuild a peer-exported entry here: host bytes to fresh tensors
    on ``device`` (owned by this process from here on)."""
    bins = []
    for b in payload["bins"]:
        shape = tuple(int(s) for s in b["shape"])
        data = _from_host_bytes(base64.b64decode(b["data"]), dtype_of(b["dtype"]), shape,
                                device)
        bins.append((shape[1:], data, int(b["count"])))
    return _Entry(None, str(payload.get("tenant", "?")), int(payload.get("flops", 0)),
                  float(payload.get("seconds", 0.0)),
                  keys=np.ascontiguousarray(payload["keys"], np.int64), bins=bins)


def _peers() -> list:
    raw = os.environ.get("DBCSR_TPU_TORCH_FLEET_PEERS", "")
    return [p.strip().rstrip("/") for p in raw.split(",") if p.strip()]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def peer_lookup(key: tuple, tenant: str = "?", device=None) -> Optional[_Entry]:
    """The fleet tier: after a local miss, ask each peer worker for the
    digest.  A hit is rebuilt on ``device``, banked locally under the
    same key (the next identical submission is a local hit) and
    returned; outcomes count as ``peer_hit``/``peer_miss``/``peer_error``."""
    import json as _json
    import urllib.error as _uerr
    import urllib.request as _rq

    global _bytes_total
    peers = _peers()
    if not peers:
        return None
    dig = digest_of_key(key)
    timeout = _env_float("DBCSR_TPU_TORCH_FLEET_CACHE_TIMEOUT_S", 0.3)
    cooloff = _env_float("DBCSR_TPU_TORCH_FLEET_PEER_COOLOFF_S", 30.0)
    now = time.monotonic()
    for peer in peers:
        with _lock:
            if _peer_down.get(peer, 0.0) > now:
                continue
        try:
            with _rq.urlopen(f"{peer}/serve/cache?digest={dig}", timeout=timeout) as resp:
                payload = _json.loads(resp.read().decode())
        except _uerr.HTTPError as exc:
            # a structured miss (404 {"found": false}) is a healthy peer
            # answering: never cool it off for not having the digest
            if exc.code == 404:
                _counter("peer_miss", tenant=tenant)
                continue
            with _lock:
                _peer_down[peer] = time.monotonic() + cooloff
            _counter("peer_error", tenant=tenant)
            continue
        except Exception:
            with _lock:
                _peer_down[peer] = time.monotonic() + cooloff
            _counter("peer_error", tenant=tenant)
            continue
        if not payload or not payload.get("found"):
            _counter("peer_miss", tenant=tenant)
            continue
        try:
            ent = entry_from_wire(payload, device)
        except Exception:
            _counter("peer_error", tenant=tenant)
            continue
        with _lock:
            if key not in _entries:
                _entries[key] = ent
                _by_digest[dig] = key
                _bytes_total += ent.nbytes
                _bytes_by_tenant[ent.tenant] = \
                    _bytes_by_tenant.get(ent.tenant, 0) + ent.nbytes
        _counter("peer_hit", tenant=tenant)
        _bytes_gauges()
        return ent
    return None
