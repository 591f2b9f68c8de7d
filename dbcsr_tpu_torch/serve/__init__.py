"""dbcsr_tpu_torch.serve -- the multi-tenant serving plane.

Counterpart of `dbcsr_tpu/serve/`:

* `session` -- a tenant's named matrices on one device, owned by a
  `core.mempool.chain`-backed scope and freed wholesale on close.
* `queue` -- the bounded priority admission queue driven by
  `obs.health.admission_status`: shed with a structured rejection on
  CRITICAL, queue with an enforced deadline on DEGRADED, admit on OK;
  per-tenant quotas and deadlines in the watchdog's taxonomy.
* `coalesce` -- same-structure multiply requests arriving within
  ``serve_window_ms`` run as ONE block-diagonal composite multiply on
  the hand-written kernels, bit for bit each standalone product.
* `engine` -- the single-writer worker on one device: correlation on
  the event bus, per-tenant latency, the ``serve_admit`` and
  ``serve_execute`` fault sites, the per-request ABFT probe, the drain
  journal and its replay.
* `product_cache` -- identical (A, B, scalars, flags) submissions,
  keyed by value digests, return the cached C with no launch.
* `workload` -- the terminal-request trace recorder
  (``DBCSR_TPU_TORCH_WORKLOAD=<base>``), the trace model and
  synthesizer, and the deterministic replay primitives.
* `router` and `fleet` -- N worker processes behind a health-aware
  router with exactly-once failover (`python -m
  dbcsr_tpu_torch.serve.fleet --demo`).

The HTTP surface is `obs.server` (``/serve/*``).
"""

from dbcsr_tpu_torch.serve.engine import (  # noqa: F401
    ServeEngine,
    get_engine,
    shutdown,
)
from dbcsr_tpu_torch.serve.queue import Rejected, Request  # noqa: F401
from dbcsr_tpu_torch.serve.session import Session, get_session  # noqa: F401

# imported for its env activation (DBCSR_TPU_TORCH_WORKLOAD) and so the
# queue's sys.modules hook finds the recorder
from dbcsr_tpu_torch.serve import workload  # noqa: F401

__all__ = [
    "ServeEngine", "get_engine", "shutdown",
    "Rejected", "Request", "Session", "get_session",
]
