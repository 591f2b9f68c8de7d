"""dbcsr_tpu_torch.obs: span tracing, metrics, the flight recorder, the
event bus, the profile epochs, and the telemetry, health and diagnosis
plane.

Counterpart of the core of `dbcsr_tpu/obs` (ref `dbcsr_timings_report.F`,
the STATISTICS block `dbcsr_mm_sched.F:390-546`):

* `tracer`: every `core.timings.timed` region as a span, streamed to
  JSONL and exported as a Chrome trace (``DBCSR_TPU_TORCH_TRACE=<path>``
  or `enable_trace(path)`);
* `metrics`: counters, gauges and histograms over `core.stats`, with
  `snapshot` (roofline rollup included) and `prometheus_text`;
* `costmodel`: the flop and byte model, the peaks, the tolerances;
* `flight`: the ring of the last multiplies, `dump`;
* `events`: the event bus with per-multiply correlation ids and its
  JSONL sink (``DBCSR_TPU_TORCH_EVENTS=<path>``);
* `profiler`: per-(driver, cell, phase) epochs, `merge`, `diff`;
* `shard`: the per-process shard naming the sinks share;
* `windows`: the median, MAD and quantile conventions;
* `timeseries`: the sampled multi-resolution store of every live signal
  (``DBCSR_TPU_TORCH_TS``), with `query` over live rings or shards;
* `slo`: multi-window burn rates over the store;
* `health`: per-component OK/DEGRADED/CRITICAL verdicts and the anomaly
  detectors fed at every product's end;
* `changepoint` and `rca`: CUSUM level shifts over the store and the
  change ledger that ranks their causes;
* `attribution` and `incidents` (imported on first use): tenant cost
  billing and the rate-limited incident bundles;
* `server`: the opt-in stdlib HTTP endpoint
  (``DBCSR_TPU_TORCH_OBS_PORT``) of the live state and the serving
  plane.
"""

from dbcsr_tpu_torch.obs import shard
from dbcsr_tpu_torch.obs import windows
from dbcsr_tpu_torch.obs import tracer
from dbcsr_tpu_torch.obs import flight
from dbcsr_tpu_torch.obs import events
from dbcsr_tpu_torch.obs import costmodel
from dbcsr_tpu_torch.obs import metrics
from dbcsr_tpu_torch.obs import timeseries
from dbcsr_tpu_torch.obs import slo
from dbcsr_tpu_torch.obs import health
from dbcsr_tpu_torch.obs import profiler
from dbcsr_tpu_torch.obs import changepoint
from dbcsr_tpu_torch.obs import rca
from dbcsr_tpu_torch.obs import server

from dbcsr_tpu_torch.obs.tracer import (  # noqa: F401
    add as trace_add,
    annotate,
    instant,
    shard_path,
    write_chrome_trace,
)

# version of the machine-readable obs artifacts (the JAX package's
# schema these records follow)
OBS_SCHEMA_VERSION = 7


def enable_trace(path: str | None = None) -> "tracer.Tracer":
    """Start a trace session (`tracer.enable`)."""
    return tracer.enable(path)


def disable_trace() -> None:
    """End the trace session, writing the JSONL and the Chrome trace."""
    tracer.disable()


def trace_enabled() -> bool:
    return tracer.active()


def get_tracer() -> "tracer.Tracer | None":
    return tracer.get()


def obs_active() -> bool:
    """Whether an opt-in obs layer is on in this process: a trace
    session, the HTTP endpoint, the events sink, or records in the event
    ring."""
    return (tracer.active() or server.running() or events.sink_active()
            or (events.enabled() and bool(events.records(limit=1))))


__all__ = [
    "tracer", "flight", "metrics", "costmodel", "events", "shard", "profiler",
    "windows", "timeseries", "slo", "health", "changepoint", "rca", "server",
    "enable_trace", "disable_trace", "trace_enabled", "get_tracer",
    "annotate", "trace_add", "instant", "shard_path",
    "write_chrome_trace", "OBS_SCHEMA_VERSION", "obs_active",
]
