"""Library lifecycle: `init_lib`, `finalize_lib` and `print_statistics`.

Counterpart of `dbcsr_tpu/core/lib.py` (ref `dbcsr_init_lib` /
`dbcsr_finalize_lib`, `src/core/dbcsr_lib.F:108-366`).  The JAX package
switches JAX to 64-bit dtypes at init; torch has no such switch, so
`init_lib` only marks the library initialized.  `finalize_lib` prints
the statistics when asked and resets them and the timers.
"""

from __future__ import annotations

import json

from dbcsr_tpu_torch.core import stats, timings

_initialized = False


def init_lib() -> None:
    global _initialized
    _initialized = True


def finalize_lib(print_stats: bool = False, out=print) -> None:
    global _initialized
    if print_stats:
        print_statistics(out=out)
    stats.reset()
    timings.reset()
    _initialized = False


def print_statistics(out=print) -> None:
    """The STATISTICS table, the timers and, when an opt-in obs layer
    captured something (a trace session, the events sink or ring), one
    JSON line of `obs.metrics.snapshot()` and the final
    `obs.health.verdict()` (ref `dbcsr_print_statistics`,
    `src/core/dbcsr_lib.F:326`)."""
    from dbcsr_tpu_torch import obs
    from dbcsr_tpu_torch.obs import health, metrics

    stats.print_statistics(out=out)
    timings.report(out=out)
    if obs.obs_active():
        out(" -" + "OBS SNAPSHOT (machine-readable)".center(68) + "-")
        out(json.dumps({"obs_schema": obs.OBS_SCHEMA_VERSION, "snapshot": metrics.snapshot(),
                        "health": health.verdict()}, default=str))
