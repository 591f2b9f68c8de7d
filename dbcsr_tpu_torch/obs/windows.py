"""Rolling-window statistics: the one quantile, median and MAD
implementation the obs plane shares.

A copy of `dbcsr_tpu/obs/windows.py`, with its output conventions:

* `median` / `mad`: the true median (the mean of the two middle
  elements on even length) and the median of absolute deviations
  (`obs.health`'s latency detector, `obs.changepoint`'s baselines);
* `rank_quantile`: ``sorted_xs[min(n - 1, int(n * q))]`` (the upper
  median at q = 0.5, not `median`'s interpolated one);
* `Window`: a bounded rolling window with O(1) running sums.

Stdlib-only.
"""

from __future__ import annotations

import collections


def median(xs) -> float:
    """True median (interpolated on even length)."""
    xs = sorted(xs)
    n = len(xs)
    if n == 0:
        return 0.0
    mid = n // 2
    return float(xs[mid]) if n % 2 else (xs[mid - 1] + xs[mid]) / 2.0


def mad(xs) -> float:
    """Median absolute deviation (same convention as `median`)."""
    m = median(xs)
    return median([abs(x - m) for x in xs])


def rank_quantile(sorted_xs, q: float) -> float:
    """The exact empirical quantile over an already sorted sequence:
    ``sorted_xs[min(n - 1, int(n * q))]``."""
    n = len(sorted_xs)
    if n == 0:
        return 0.0
    return float(sorted_xs[min(n - 1, int(n * q))])


def p50_p95(values) -> tuple:
    """(p50, p95) of an unsorted sample via `rank_quantile`."""
    xs = sorted(values)
    return rank_quantile(xs, 0.5), rank_quantile(xs, 0.95)


class Window:
    """Bounded rolling window of float samples with a running sum.

    `append` evicts the oldest sample once ``maxlen`` is reached and
    keeps ``sum`` incrementally — consumers that need a rate over the
    window (shed fraction, recompiles per multiply) read it O(1).
    """

    __slots__ = ("_dq", "sum")

    def __init__(self, maxlen: int):
        self._dq: collections.deque = collections.deque(
            maxlen=max(1, int(maxlen)))
        self.sum = 0.0

    def append(self, v: float) -> None:
        if len(self._dq) == self._dq.maxlen:
            self.sum -= self._dq[0]
        self._dq.append(v)
        self.sum += v

    def __len__(self) -> int:
        return len(self._dq)

    def __iter__(self):
        return iter(self._dq)

    def mean(self) -> float:
        n = len(self._dq)
        return self.sum / n if n else 0.0

    def clear(self) -> None:
        self._dq.clear()
        self.sum = 0.0
