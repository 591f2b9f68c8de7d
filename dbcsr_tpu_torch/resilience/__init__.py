"""dbcsr_tpu_torch.resilience: fault injection, the stack-driver breakers
and the watchdog.

Counterpart of `dbcsr_tpu/resilience/`:

* `faults`: deterministic, seeded fault injection at the port's sites
  (`sites.py`), configured by ``DBCSR_TPU_TORCH_FAULTS`` or the
  `inject_faults` context manager;
* `breaker`: per-(driver, shape) circuit breakers behind the failover
  chain of `acc.smm.execute_stack` (pallas_cross -> pallas on the
  card; torch and host follow for CPU tensors);
* `watchdog`: the deadline-guarded executor of the multi-process
  world's join (``mp_world_join``) and the tuner's trials
  (``tune_trial``): OK/SLOW/TRANSIENT/WEDGED, seeded backoff.

With no fault configured and no failure recorded, every hook is one
attribute check.
"""

from dbcsr_tpu_torch.resilience import breaker, faults, watchdog
from dbcsr_tpu_torch.resilience.breaker import BreakerBoard, get_board, reset_board
from dbcsr_tpu_torch.resilience.faults import FaultError, FaultSpec, inject_faults
from dbcsr_tpu_torch.resilience.watchdog import (
    DeadlineExceeded,
    Watchdog,
    WatchdogResult,
    run_guarded,
)

__all__ = ["faults", "breaker", "watchdog", "FaultSpec", "FaultError", "inject_faults",
           "BreakerBoard", "get_board", "reset_board", "Watchdog", "WatchdogResult",
           "DeadlineExceeded", "run_guarded"]
