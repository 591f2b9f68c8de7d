"""Counter, gauge and histogram registry with a snapshot and the
Prometheus text.

Counterpart of `dbcsr_tpu/obs/metrics.py`.  Labelled counters, gauges
and fixed-bucket histograms, each holding its values keyed by the sorted
``(label, value)`` tuple.  `snapshot` folds in the `core.stats` layers
(per-(m,n,k) and per-driver flops, collective traffic, the memory
meters), the per-driver roofline rollup (`costmodel.roofline` on the
device's peak row, which also refreshes the ``dbcsr_tpu_achieved_gflops``,
``dbcsr_tpu_roofline_fraction`` and ``dbcsr_tpu_arithmetic_intensity``
gauges), the memory pool's counters and the first-use mirror
(`jit_stats`); `prometheus_text` renders the same as text exposition
0.0.4.

`record_jit` is the port's counterpart of the JAX package's jit-cache
mirror: PyTorch compiles nothing per shape, so the "specialization" of a
kernel is its first-use validated shape (kernel, form, m, n, k, dtype):
its first launch counts a compile (`acc.smm._ensure_validated`), every
later one a cache hit.

Stdlib-only at import: the stack path imports it; `core.stats` and the
cost model are reached inside the functions.
"""

from __future__ import annotations

import json
import sys
import threading

_lock = threading.Lock()


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Counter:
    """Monotone counter with optional labels."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.values: dict = {}

    def inc(self, n: float = 1, **labels) -> None:
        key = _label_key(labels)
        self.values[key] = self.values.get(key, 0) + n

    def value(self, **labels) -> float:
        return self.values.get(_label_key(labels), 0)


class Gauge:
    """Point-in-time value with optional labels."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.values: dict = {}

    def set(self, v: float, **labels) -> None:
        self.values[_label_key(labels)] = v

    def value(self, **labels) -> float:
        return self.values.get(_label_key(labels), 0)


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus ``le``
    convention) with a running sum and count."""

    DEFAULT_BUCKETS = (1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0, 30.0)

    def __init__(self, name: str, help: str = "", buckets=None):
        self.name = name
        self.help = help
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self.values: dict = {}  # label key -> [counts per bucket, +inf]
        self.sums: dict = {}
        self.counts: dict = {}

    def observe(self, v: float, **labels) -> None:
        key = _label_key(labels)
        counts = self.values.setdefault(key, [0] * (len(self.buckets) + 1))
        for i, b in enumerate(self.buckets):
            if v <= b:
                counts[i] += 1
        counts[-1] += 1
        self.sums[key] = self.sums.get(key, 0.0) + v
        self.counts[key] = self.counts.get(key, 0) + 1


_counters: dict = {}
_gauges: dict = {}
_histograms: dict = {}
# specialization keys seen per function (the first-use mirror)
_jit_seen: dict = {}


def counter(name: str, help: str = "") -> Counter:
    with _lock:
        c = _counters.get(name)
        if c is None:
            c = _counters[name] = Counter(name, help)
        return c


def counter_items(name: str) -> list:
    """One counter's ``(labels_dict, value)`` pairs; empty when it never
    incremented."""
    with _lock:
        c = _counters.get(name)
        if c is None:
            return []
        return [(dict(k), float(v)) for k, v in c.values.items()]


def gauge(name: str, help: str = "") -> Gauge:
    with _lock:
        g = _gauges.get(name)
        if g is None:
            g = _gauges[name] = Gauge(name, help)
        return g


def histogram(name: str, help: str = "", buckets=None) -> Histogram:
    with _lock:
        h = _histograms.get(name)
        if h is None:
            h = _histograms[name] = Histogram(name, help, buckets)
        return h


def record_jit(fn: str, key) -> bool:
    """Report one launch of ``fn`` at specialization ``key``: the first
    sighting of a key counts a compile (``dbcsr_tpu_jit_compiles_total``
    and a ``jit_compile`` event), every later one a cache hit.  Returns
    whether this launch was the first."""
    seen = _jit_seen.setdefault(fn, set())
    if key in seen:
        counter("dbcsr_tpu_jit_cache_hits_total",
                "kernel launches at an already validated shape").inc(fn=fn)
        return False
    seen.add(key)
    counter("dbcsr_tpu_jit_compiles_total",
            "kernel shapes validated on first use, per kernel").inc(fn=fn)
    from dbcsr_tpu_torch.obs import events as _events

    _events.publish("jit_compile", {"fn": fn, "key": str(key)})
    return True


def jit_stats() -> dict:
    """{fn: {"compiles": n, "cache_hits": n}} of every `record_jit` caller."""
    out: dict = {}
    for name, field in (("dbcsr_tpu_jit_compiles_total", "compiles"),
                        ("dbcsr_tpu_jit_cache_hits_total", "cache_hits")):
        c = _counters.get(name)
        if c is None:
            continue
        for key, v in c.values.items():
            fn = dict(key).get("fn", "?")
            out.setdefault(fn, {"compiles": 0, "cache_hits": 0})[field] = v
    return out


def reset(include_stats: bool = True) -> None:
    """Clear the registries and the first-use mirror; ``include_stats``
    also resets `core.stats` (flops, traffic, driver rollups, memory
    meters), the memory pool's counters, and, after them, the tenant
    attribution ledger (re-baselined on the zeroed rollup), the incident
    budget, the profile epochs, the change-point baselines and the
    change ledger, so that ``reset(); snapshot()`` starts fresh."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _histograms.clear()
        _jit_seen.clear()
    if include_stats:
        from dbcsr_tpu_torch.core import stats

        stats.reset()
        mp = sys.modules.get("dbcsr_tpu_torch.core.mempool")
        if mp is not None:
            mp.reset_stats()
        for name in ("attribution", "incidents", "profiler", "changepoint", "rca"):
            mod = sys.modules.get(f"dbcsr_tpu_torch.obs.{name}")
            if mod is not None:
                mod.reset()


def _roofline_rollup() -> dict:
    """The roofline of every driver in `core.stats.driver_rollup` on the
    device's peak row (at its dominant dtype), refreshing the roofline
    gauges.  ``sync`` is true when every region's seconds ended at a
    synchronize."""
    from dbcsr_tpu_torch.core import stats
    from dbcsr_tpu_torch.obs import costmodel

    kind = costmodel.device_kind()
    out: dict = {}
    for driver, agg in sorted(stats.driver_rollup().items()):
        dtype = max(agg["by_dtype"], key=agg["by_dtype"].get) if agg["by_dtype"] else "float64"
        rl = costmodel.roofline(agg["flops"], agg["bytes"], agg["seconds"], kind=kind,
                                dtype=dtype)
        rl["stacks"] = agg["stacks"]
        rl["sync"] = bool(agg["stacks"]) and agg["sync_stacks"] == agg["stacks"]
        out[driver] = rl
        gauge("dbcsr_tpu_achieved_gflops", "flops / dispatch seconds per stack driver").set(
            rl["achieved_gflops"], driver=driver)
        gauge("dbcsr_tpu_roofline_fraction",
              "achieved rate / attainable roofline rate per driver "
              "(min(peak compute, intensity*bandwidth) denominator)").set(
            rl["roofline_fraction"], driver=driver)
        gauge("dbcsr_tpu_arithmetic_intensity", "modeled flops per HBM byte per driver").set(
            rl["arithmetic_intensity"], driver=driver)
    for engine, grids in stats.cannon_overlap_rollup().items():
        out.setdefault(engine, {})["cannon_overlap"] = grids
    return out


def _stats_snapshot() -> dict:
    """The `core.stats` registries as plain dicts."""
    from dbcsr_tpu_torch.core import stats

    by_driver: dict = {}
    by_mnk = {}
    for (m, n, k), st in stats._by_mnk.items():
        by_mnk[f"{m}x{n}x{k}"] = {"stacks": st.nstacks, "entries": st.nentries,
                                  "flops": st.flops, "by_driver": dict(st.by_driver)}
        for d, f in st.by_driver.items():
            by_driver[d] = by_driver.get(d, 0) + f
    comm = {kind: {"messages": st.nmessages, "bytes": st.nbytes}
            for kind, st in stats._comm.items()}
    return {"flops_by_driver": by_driver, "by_mnk": by_mnk, "comm": comm,
            "totals": dict(stats._totals), "memory": stats.memory_high_water()}


def snapshot() -> dict:
    """Everything observable as one dict: the `core.stats` layers, the
    roofline rollup and the device kind, the pool's counters, this
    registry's counters, gauges and histograms (each name mapped to
    {json label object: value}), and the first-use mirror."""
    from dbcsr_tpu_torch.obs import costmodel

    def expand(metrics):
        return {name: {json.dumps(dict(k)): v for k, v in m.values.items()}
                for name, m in metrics.items()}

    snap = _stats_snapshot()
    snap["roofline"] = _roofline_rollup()  # before the gauges are expanded
    snap["device_kind"] = costmodel.device_kind()
    mp = sys.modules.get("dbcsr_tpu_torch.core.mempool")
    if mp is not None:
        snap["pool"] = mp.pool_stats()
        snap["transfer"] = mp.transfer_totals()
    with _lock:
        snap["counters"] = expand(_counters)
        snap["gauges"] = expand(_gauges)
        snap["histograms"] = {
            name: {
                json.dumps(dict(k)): {
                    "buckets": dict(zip([str(b) for b in h.buckets] + ["+Inf"], v)),
                    "sum": h.sums.get(k, 0.0),
                    "count": h.counts.get(k, 0),
                }
                for k, v in h.values.items()
            }
            for name, h in _histograms.items()
        }
    snap["jit"] = jit_stats()
    return snap


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


def prometheus_text() -> str:
    """Prometheus text exposition (0.0.4): the `core.stats` layers as
    ``dbcsr_tpu_*`` families, then every counter, gauge and histogram."""
    from dbcsr_tpu_torch.core import stats

    _roofline_rollup()  # refresh the roofline gauges first
    lines: list = []

    def emit(name, kind, help, values):
        lines.append(f"# HELP {name} {help}")
        lines.append(f"# TYPE {name} {kind}")
        for key, v in values:
            lines.append(f"{name}{_fmt_labels(key)} {v}")

    by_driver: dict = {}
    for st in stats._by_mnk.values():
        for d, f in st.by_driver.items():
            by_driver[d] = by_driver.get(d, 0) + f
    emit("dbcsr_tpu_flops_total", "counter", "true flops per stack driver",
         [((("driver", d),), f) for d, f in sorted(by_driver.items())])
    emit("dbcsr_tpu_comm_bytes_total", "counter", "collective traffic bytes per collective kind",
         [((("kind", k),), st.nbytes) for k, st in sorted(stats._comm.items())])
    emit("dbcsr_tpu_comm_messages_total", "counter",
         "collective message counts per collective kind",
         [((("kind", k),), st.nmessages) for k, st in sorted(stats._comm.items())])
    emit("dbcsr_tpu_multiplies_total", "counter", "multiply() invocations",
         [((), stats._totals["multiplies"])])
    emit("dbcsr_tpu_memory_bytes", "gauge", "host/device memory meters (peak and current)",
         [((("meter", k),), v) for k, v in sorted(stats.memory_high_water().items())])
    with _lock:
        for name, c in sorted(_counters.items()):
            emit(name, "counter", c.help or name, sorted(c.values.items()))
        for name, g in sorted(_gauges.items()):
            emit(name, "gauge", g.help or name, sorted(g.values.items()))
        for name, h in sorted(_histograms.items()):
            lines.append(f"# HELP {name} {h.help or name}")
            lines.append(f"# TYPE {name} histogram")
            for key, counts in sorted(h.values.items()):
                for b, cnt in zip([str(b) for b in h.buckets] + ["+Inf"], counts):
                    lines.append(f"{name}_bucket{_fmt_labels(key + (('le', b),))} {cnt}")
                lines.append(f"{name}_sum{_fmt_labels(key)} {h.sums.get(key, 0.0)}")
                lines.append(f"{name}_count{_fmt_labels(key)} {h.counts.get(key, 0)}")
    return "\n".join(lines) + "\n"
