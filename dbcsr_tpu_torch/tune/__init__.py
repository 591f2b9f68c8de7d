"""dbcsr_tpu_torch.tune: the online tuner, telemetry in, promoted kernel
parameters out.

Counterpart of `dbcsr_tpu/tune/` over the port's parameter table
(`acc.params`, the committed H100 table written by `acc.tune`):

* `miner`: ranks underperforming (driver, m, n, k, dtype) cells of the
  telemetry store (`obs.timeseries`, device rates only) and of this
  device's capture rows by wasted FLOP-seconds;
* `trials`: bounded, watchdog-guarded candidate sweeps
  (`acc.tune.tune_smm` without persisting) and format trials, with the
  ``tune_trial`` fault site and breaker-aware winner selection;
* `store`: promotion and demotion with a provenance ledger, the params
  generation bump that retires cached plans, and the peer-sync client;
* `predictor`: cross-kind transfer, a ridge regressor and the format
  planner's donor row (`format_prior`);
* `service`: the cycle loop (`TuneService.cycle()`, or a background
  thread under ``DBCSR_TPU_TORCH_TUNE=1``).

Observability: the ``tune`` health component,
``dbcsr_tpu_tune_{trials,promotions,demotions}_total``, the
``tune_promotion``/``tune_demotion``/``tune_trial`` events and a
telemetry collector.
"""

from dbcsr_tpu_torch.tune.service import (  # noqa: F401
    TuneService,
    current_service,
    get_service,
    maybe_start_from_env,
    stop_service,
)

__all__ = [
    "TuneService",
    "current_service",
    "get_service",
    "maybe_start_from_env",
    "stop_service",
]
