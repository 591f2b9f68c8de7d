"""Counter, gauge and histogram registry.

The subset of `dbcsr_tpu/obs/metrics.py:34-135,181,321` the integrity
plane calls: labelled counters, gauges and fixed-bucket histograms,
`counter_items` to read one counter back, `reset`, and `snapshot` of the
registry.  Each metric holds its values keyed by the sorted ``(label,
value)`` tuple, as in the JAX package.  Not ported yet: the jit-recompile
mirror, the roofline rollup, the `core.stats` layers of the snapshot and
the Prometheus text (`ROADMAP.md`, obs).

Stdlib-only: the stack path imports it.
"""

from __future__ import annotations

import json
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


def reset() -> None:
    """Clear the registries."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _histograms.clear()


def snapshot() -> dict:
    """The registry as one dict: ``counters`` and ``gauges`` map each
    name to {json label object: value}, ``histograms`` to its buckets,
    sum and count per label set."""

    def expand(metrics):
        return {name: {json.dumps(dict(k)): v for k, v in m.values.items()}
                for name, m in metrics.items()}

    with _lock:
        return {
            "counters": expand(_counters),
            "gauges": expand(_gauges),
            "histograms": {
                name: {
                    json.dumps(dict(k)): {
                        "buckets": dict(zip([str(b) for b in h.buckets] + ["+Inf"], v)),
                        "sum": h.sums.get(k, 0.0),
                        "count": h.counts.get(k, 0),
                    }
                    for k, v in h.values.items()
                }
                for name, h in _histograms.items()
            },
        }
