"""dbcsr_tpu_torch.resilience: fault injection and the stack-driver breakers.

Counterpart of `dbcsr_tpu/resilience/`, without the watchdog (it guards
the JAX package's TPU probe and multi-process joins, which the port
does not have yet):

* `faults`: deterministic, seeded fault injection at the port's sites
  (`sites.py`), configured by ``DBCSR_TPU_TORCH_FAULTS`` or the
  `inject_faults` context manager;
* `breaker`: per-(driver, shape) circuit breakers behind the failover
  chain of `acc.smm.execute_stack` (pallas_cross -> pallas on the
  card; torch and host follow for CPU tensors).

With no fault configured and no failure recorded, every hook is one
attribute check.
"""

from dbcsr_tpu_torch.resilience import breaker, faults
from dbcsr_tpu_torch.resilience.breaker import BreakerBoard, get_board, reset_board
from dbcsr_tpu_torch.resilience.faults import FaultError, FaultSpec, inject_faults

__all__ = ["faults", "breaker", "FaultSpec", "FaultError", "inject_faults",
           "BreakerBoard", "get_board", "reset_board"]
