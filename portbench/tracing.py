"""Reduction of a `torch.profiler` trace of the measured window.

The benchmark opens its own spans with `torch.profiler.record_function`
("portbench:<name>") around each call into a layer; the program's
`core/timings` regions appear beside them as "dbcsr_tpu_torch:<name>".
From the trace this module reads:

- the window: the "portbench:window" span, on the trace's clock;
- busy time: the union of the intervals in which an operation (kernel,
  copy or fill) ran on a device, clipped to the window, averaged over
  the devices the run uses;
- the device operations that took the most time, by name;
- the longest idle gaps of the device, each named by the innermost host
  span open at its middle (what the host was doing while the device
  waited);
- how many device operations each kind of benchmark span launched: a
  device operation belongs to the span that was open on the host when
  its launch call (the CUDA runtime call of the same correlation id)
  began.

A trace with no device operation gives ``busy_s`` None: nothing here
turns a host time into a device number.
"""

from __future__ import annotations

import bisect
import collections

WINDOW = "portbench:window"
TOP = 10


def _events(prof):
    return prof.profiler.kineto_results.events()


def _is_device(e) -> bool:
    return e.device_type().name == "CUDA" and not e.is_user_annotation()


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans_sorted, starts, t):
    """The innermost span (latest start) open at time ``t``."""
    for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        s, e, name = spans_sorted[j]
        if e > t:
            return name
    return None


def reduce(prof, counted_spans=(), devices: int = 1) -> dict:
    """``busy_s`` (averaged over ``devices``), ``window_s``,
    ``device_ops``, ``idle_gaps`` (of the first device) and ``launches``
    {span name: device operations launched inside it} for each name of
    ``counted_spans`` (without the "portbench:" prefix)."""
    evs = list(_events(prof))
    window = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs
              if e.name() == WINDOW and e.device_type().name == "CPU"]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window[0]
    device = [e for e in evs if _is_device(e)]
    host_spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                        for e in evs if e.device_type().name == "CPU"
                        and (e.name().startswith("portbench:")
                             or e.name().startswith("dbcsr_tpu_torch:"))
                        and e.name() != WINDOW)
    out = {"window_s": (w1 - w0) * 1e-9, "busy_s": None, "device_ops": [],
           "idle_gaps": [], "launches": {n: 0 for n in counted_spans}}
    per_device = collections.defaultdict(list)
    for e in device:
        s, t = max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1)
        if t > s:
            per_device[e.device_index()].append((s, t))
    if not per_device:
        return out
    unions = {d: _union(iv) for d, iv in per_device.items()}
    out["busy_s"] = sum(t - s for iv in unions.values() for s, t in iv) * 1e-9 / devices
    busy = unions[min(unions)]
    by_name = collections.Counter()
    for e in device:
        by_name[e.name()] += e.duration_ns()
    out["device_ops"] = [[n[:160], ns * 1e-9] for n, ns in by_name.most_common(TOP)]
    starts = [s for s, _, _ in host_spans]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], (edges[i] + edges[i + 1]) // 2)
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    out["idle_gaps"] = [[_innermost(host_spans, starts, mid) or "(no span)", g * 1e-9]
                        for g, mid in gaps[:TOP]]
    # launches: device operations whose runtime call began inside a span
    launch_at = {e.correlation_id(): e.start_ns() for e in evs
                 if e.device_type().name == "CPU" and e.name().startswith("cu")}
    for name in counted_spans:
        iv = [(s, e) for s, e, n in host_spans if n == "portbench:" + name]
        s0 = [s for s, _ in iv]
        n = 0
        for e in device:
            t = launch_at.get(e.correlation_id())
            if t is None:
                continue
            k = bisect.bisect_right(s0, t) - 1
            if k >= 0 and t < iv[k][1]:
                n += 1
        out["launches"][name] = n
    return out
