"""Registry of every ``DBCSR_TPU_TORCH_*`` environment variable the port
reads, with the module that reads it and what it does.

Counterpart of `dbcsr_tpu/core/knobs.py`: pure data, no imports.
`tests/test_torch_obs.py::test_every_knob_literal_is_registered` holds
the sources to it: every
``DBCSR_TPU_TORCH_*`` literal in `dbcsr_tpu_torch/` and `chip_smoke.py`
is an entry here, and every entry is read somewhere.  The config's
fields (`core/config.py`) have no environment variable.
"""

KNOBS = {
    "DBCSR_TPU_TORCH_ATTRIBUTION": {
        "owner": "obs/attribution.py",
        "doc": "=0 turns every tenant-billing hook into an early return.",
    },
    "DBCSR_TPU_TORCH_ATTRIBUTION_N": {
        "owner": "obs/attribution.py",
        "doc": "requests the attribution ledger keeps (default 1024).",
    },
    "DBCSR_TPU_TORCH_ATTRIBUTION_TENANTS": {
        "owner": "obs/attribution.py",
        "doc": "tenant rows kept before the least recently active fold into "
               "(evicted) (default 512).",
    },
    "DBCSR_TPU_TORCH_BREAKER_COOLDOWN_S": {
        "owner": "resilience/breaker.py",
        "doc": "seconds an open breaker waits before its half-open trial.",
    },
    "DBCSR_TPU_TORCH_BREAKER_THRESHOLD": {
        "owner": "resilience/breaker.py",
        "doc": "consecutive failures that open a (driver, shape) breaker.",
    },
    "DBCSR_TPU_TORCH_CHANGEPOINT": {
        "owner": "obs/changepoint.py",
        "doc": "0 or off turns change-point detection off.",
    },
    "DBCSR_TPU_TORCH_CHECK_OUTPUTS": {
        "owner": "acc/smm.py",
        "doc": "=1 at import: a finite-output check after every stack launch.",
    },
    "DBCSR_TPU_TORCH_CHECKSUM_RETRY": {
        "owner": "perf/driver.py",
        "doc": "=0: run_perf raises on a checksum mismatch at once, with no repeat "
               "on the safe driver (chip_smoke.py's gates).",
    },
    "DBCSR_TPU_TORCH_CP_H": {
        "owner": "obs/changepoint.py",
        "doc": "CUSUM decision threshold in baseline sigmas (default 8).",
    },
    "DBCSR_TPU_TORCH_CP_REF_N": {
        "owner": "obs/changepoint.py",
        "doc": "samples frozen into a change-point baseline (default 12).",
    },
    "DBCSR_TPU_TORCH_EVENTS": {
        "owner": "obs/events.py",
        "doc": "base path of the event bus's JSONL sink (one shard per process); "
               "0 or off turns the bus off.",
    },
    "DBCSR_TPU_TORCH_FAULTS": {
        "owner": "resilience/faults.py",
        "doc": "fault-injection specs (the JAX package's DSL), read on first "
               "use.",
    },
    "DBCSR_TPU_TORCH_FLEET_BACKOFF_S": {
        "owner": "serve/router.py",
        "doc": "base seconds of the router's exponential backoff between submit attempts "
               "(default 0.05).",
    },
    "DBCSR_TPU_TORCH_FLEET_CACHE_TIMEOUT_S": {
        "owner": "tune/store.py",
        "doc": "seconds peer_sync waits for one peer (default 0.3).",
    },
    "DBCSR_TPU_TORCH_FLEET_HEARTBEAT_TIMEOUT_S": {
        "owner": "serve/router.py",
        "doc": "seconds one heartbeat or /healthz probe may take (default 2).",
    },
    "DBCSR_TPU_TORCH_FLEET_PEERS": {
        "owner": "tune/store.py",
        "doc": "comma-separated base URLs of same-device-kind peers whose "
               "promotions peer_sync adopts (and whose product caches a serve "
               "worker asks after a local miss, serve/product_cache.py).",
    },
    "DBCSR_TPU_TORCH_FLEET_PEER_COOLOFF_S": {
        "owner": "tune/store.py",
        "doc": "seconds a peer that errored is skipped (default 30).",
    },
    "DBCSR_TPU_TORCH_FLEET_RETRIES": {
        "owner": "serve/router.py",
        "doc": "attempts the router makes to land one request on its worker (default 3).",
    },
    "DBCSR_TPU_TORCH_FLEET_SUBMIT_TIMEOUT_S": {
        "owner": "serve/router.py",
        "doc": "seconds one routed HTTP call may take (default 10).",
    },
    "DBCSR_TPU_TORCH_FLEET_SUSPECT_AFTER": {
        "owner": "serve/router.py",
        "doc": "consecutive missed heartbeats that declare a worker DOWN (default 3).",
    },
    "DBCSR_TPU_TORCH_HEALTH_BREAKER_CRITICAL_N": {
        "owner": "obs/health.py",
        "doc": "open breakers that make the drivers component CRITICAL (default "
               "4).",
    },
    "DBCSR_TPU_TORCH_HEALTH_COLLAPSE_RATIO": {
        "owner": "obs/health.py",
        "doc": "roofline collapse below this share of the window median (default "
               "0.5).",
    },
    "DBCSR_TPU_TORCH_HEALTH_FALLBACK_RATE": {
        "owner": "obs/health.py",
        "doc": "failovers per multiply over the window that fire fallback_storm "
               "(default 0.25).",
    },
    "DBCSR_TPU_TORCH_HEALTH_LATENCY_RELTOL": {
        "owner": "obs/health.py",
        "doc": "least relative margin over the window median of a latency spike "
               "(default 0.5).",
    },
    "DBCSR_TPU_TORCH_HEALTH_POOL_EVICTIONS": {
        "owner": "obs/health.py",
        "doc": "budget evictions at which a missing pool reads as thrash "
               "(default 8).",
    },
    "DBCSR_TPU_TORCH_HEALTH_RECOMPILE_RATE": {
        "owner": "obs/health.py",
        "doc": "first-use validations per multiply over the window that fire "
               "recompile_storm (default 0.5).",
    },
    "DBCSR_TPU_TORCH_HEALTH_SDC_CRITICAL": {
        "owner": "obs/health.py",
        "doc": "unrecovered ABFT mismatches that make integrity CRITICAL "
               "(default 3).",
    },
    "DBCSR_TPU_TORCH_HEALTH_SHED_RATE": {
        "owner": "obs/health.py",
        "doc": "shed fraction of the admission window that fires shed_storm "
               "(default 0.25).",
    },
    "DBCSR_TPU_TORCH_HEALTH_WINDOW": {
        "owner": "obs/health.py",
        "doc": "multiplies in the anomaly detectors' window (default 64).",
    },
    "DBCSR_TPU_TORCH_INCIDENTS": {
        "owner": "obs/incidents.py",
        "doc": "directory of the incident bundles; unset or 0 keeps them in "
               "memory only.",
    },
    "DBCSR_TPU_TORCH_INCIDENT_INTERVAL_S": {
        "owner": "obs/incidents.py",
        "doc": "least seconds between two incident bundles (default 60).",
    },
    "DBCSR_TPU_TORCH_INCIDENT_N": {
        "owner": "obs/incidents.py",
        "doc": "most incident bundles a process captures (default 8).",
    },
    "DBCSR_TPU_TORCH_LOCKCHECK": {
        "owner": "utils/lockcheck.py",
        "doc": "=1 at import: the mempool and telemetry locks assert a "
               "consistent acquisition order.",
    },
    "DBCSR_TPU_TORCH_MULTIHOST_TIMEOUT_S": {
        "owner": "parallel/multihost.py",
        "doc": "seconds `init_multihost` waits for the world's rendezvous before "
               "it degrades to serial (default 300).",
    },
    "DBCSR_TPU_TORCH_NATIVE": {
        "owner": "native/__init__.py",
        "doc": "=0 runs the multiply's index build and sort on the NumPy path "
               "instead of the native engine.",
    },
    "DBCSR_TPU_TORCH_OBS_HOST": {
        "owner": "obs/server.py",
        "doc": "address the HTTP endpoint binds (default 127.0.0.1).",
    },
    "DBCSR_TPU_TORCH_OBS_PORT": {
        "owner": "obs/server.py",
        "doc": "at import: serve the HTTP endpoint on this base port (+ the rank).",
    },
    "DBCSR_TPU_TORCH_PARAMS_DIR": {
        "owner": "acc/params.py",
        "doc": "directory of the tuned parameter table.",
    },
    "DBCSR_TPU_TORCH_PEAK_GBS": {
        "owner": "obs/costmodel.py",
        "doc": "device memory bandwidth (GB/s) the roofline uses in place of the "
               "peak table's.",
    },
    "DBCSR_TPU_TORCH_PEAK_GFLOPS": {
        "owner": "obs/costmodel.py",
        "doc": "peak compute (GFLOP/s, every dtype) the roofline uses in place "
               "of the peak table's.",
    },
    "DBCSR_TPU_TORCH_POOL": {
        "owner": "core/mempool.py",
        "doc": "=0 turns the device buffer pool and the residency of filtered "
               "plans off.",
    },
    "DBCSR_TPU_TORCH_RCA": {
        "owner": "obs/rca.py",
        "doc": "0 or off turns the change ledger and the causal ranking off.",
    },
    "DBCSR_TPU_TORCH_RCA_LEDGER_N": {
        "owner": "obs/rca.py",
        "doc": "change-ledger entries kept (default 256).",
    },
    "DBCSR_TPU_TORCH_RCA_WINDOW_S": {
        "owner": "obs/rca.py",
        "doc": "seconds before a shift a change can still be its cause (default "
               "600).",
    },
    "DBCSR_TPU_TORCH_ROOFLINE": {
        "owner": "obs/costmodel.py",
        "doc": "JSON dict of peak rows merged over the roofline table.",
    },
    "DBCSR_TPU_TORCH_SERVE_JOURNAL": {
        "owner": "serve/engine.py",
        "doc": "the drain/write-ahead journal path; an engine started with it replays "
               "what it holds.",
    },
    "DBCSR_TPU_TORCH_SERVE_TENANT_MAX": {
        "owner": "serve/engine.py",
        "doc": "tenant rows of latency and outcome tallies an engine keeps (default 256).",
    },
    "DBCSR_TPU_TORCH_SERVE_TENANT_TTL_S": {
        "owner": "serve/engine.py",
        "doc": "seconds an idle tenant's tallies are kept (default 3600).",
    },
    "DBCSR_TPU_TORCH_SERVE_WAL": {
        "owner": "serve/engine.py",
        "doc": "=1: journal every by-name request at submit and tombstone it at its end "
               "(fleet workers).",
    },
    "DBCSR_TPU_TORCH_SLO_CRITICAL_BURN": {
        "owner": "obs/slo.py",
        "doc": "burn rate at which a burning objective is CRITICAL (default 8).",
    },
    "DBCSR_TPU_TORCH_SLO_LONG_S": {
        "owner": "obs/slo.py",
        "doc": "the long burn window in seconds (default 600).",
    },
    "DBCSR_TPU_TORCH_SLO_ROOFLINE_BUDGET": {
        "owner": "obs/slo.py",
        "doc": "error budget of the roofline_floor objective (default 0.25).",
    },
    "DBCSR_TPU_TORCH_SLO_ROOFLINE_FLOOR": {
        "owner": "obs/slo.py",
        "doc": "roofline fraction below which a sample is bad (default 0.002).",
    },
    "DBCSR_TPU_TORCH_SLO_SDC_BUDGET": {
        "owner": "obs/slo.py",
        "doc": "error budget of unrecovered ABFT mismatches (default 1e-6).",
    },
    "DBCSR_TPU_TORCH_SLO_SERVE_ERR_BUDGET": {
        "owner": "obs/slo.py",
        "doc": "error budget of shed and late serve requests (default 0.05).",
    },
    "DBCSR_TPU_TORCH_SLO_SERVE_P95_BUDGET": {
        "owner": "obs/slo.py",
        "doc": "error budget of serve p95 samples over target (default 0.10).",
    },
    "DBCSR_TPU_TORCH_SLO_SERVE_P95_MS": {
        "owner": "obs/slo.py",
        "doc": "serve p95 latency target in ms (default 500).",
    },
    "DBCSR_TPU_TORCH_SLO_SHORT_S": {
        "owner": "obs/slo.py",
        "doc": "the short burn window in seconds (default 60).",
    },
    "DBCSR_TPU_TORCH_SYNC_TIMING": {
        "owner": "core/stats.py",
        "doc": "=1: the engine synchronizes the card after each launch, so the "
               "statistics' seconds are device seconds.",
    },
    "DBCSR_TPU_TORCH_TRACE": {
        "owner": "obs/tracer.py",
        "doc": "base path of the span tracer's JSONL (one shard per process; the "
               "Chrome trace lands beside it).",
    },
    "DBCSR_TPU_TORCH_TS": {
        "owner": "obs/timeseries.py",
        "doc": "base path of the telemetry store's JSONL shards; 0 or off turns "
               "the store off; unset keeps it in memory.",
    },
    "DBCSR_TPU_TORCH_TS_10M_N": {
        "owner": "obs/timeseries.py",
        "doc": "10-minute buckets a series keeps (default 288).",
    },
    "DBCSR_TPU_TORCH_TS_1M_N": {
        "owner": "obs/timeseries.py",
        "doc": "1-minute buckets a series keeps (default 360).",
    },
    "DBCSR_TPU_TORCH_TS_INTERVAL_S": {
        "owner": "obs/timeseries.py",
        "doc": "seconds between telemetry samples (default 10; 0 samples at "
               "every product).",
    },
    "DBCSR_TPU_TORCH_TS_RAW_N": {
        "owner": "obs/timeseries.py",
        "doc": "raw points a series keeps (default 512).",
    },
    "DBCSR_TPU_TORCH_TUNE": {
        "owner": "tune/service.py",
        "doc": "=1 starts the online tuner's background thread "
               "(maybe_start_from_env).",
    },
    "DBCSR_TPU_TORCH_TUNE_BUDGET_BYTES": {
        "owner": "tune/trials.py",
        "doc": "operand bytes a trial's stack may stage (default 64 MiB).",
    },
    "DBCSR_TPU_TORCH_TUNE_BUDGET_S": {
        "owner": "tune/trials.py",
        "doc": "wall seconds a trial may spend, checked between candidates "
               "(default 120).",
    },
    "DBCSR_TPU_TORCH_TUNE_DEMOTE_RATIO": {
        "owner": "tune/store.py",
        "doc": "live roofline share of the at-promotion value below which a "
               "promotion is demoted (default 0.5).",
    },
    "DBCSR_TPU_TORCH_TUNE_FLOOR": {
        "owner": "tune/miner.py",
        "doc": "roofline fraction below which a cell is mined (default 0.25).",
    },
    "DBCSR_TPU_TORCH_TUNE_INTERVAL_S": {
        "owner": "tune/service.py",
        "doc": "seconds between background tuner cycles (default 60).",
    },
    "DBCSR_TPU_TORCH_TUNE_MARGIN": {
        "owner": "tune/service.py",
        "doc": "share by which a winner must beat the cell's observed rate to be "
               "promoted (default 0.05).",
    },
    "DBCSR_TPU_TORCH_TUNE_MAX_CELLS": {
        "owner": "tune/miner.py",
        "doc": "cells the mined queue keeps (default 32).",
    },
    "DBCSR_TPU_TORCH_TUNE_NREP": {
        "owner": "tune/trials.py",
        "doc": "timed repeats of each trial candidate (default 2).",
    },
    "DBCSR_TPU_TORCH_WATCHDOG_LOG_MAX_BYTES": {
        "owner": "resilience/watchdog.py",
        "doc": "size past which a watchdog's outcome JSONL is rotated (default 1 "
               "MiB).",
    },
    "DBCSR_TPU_TORCH_WORKLOAD": {
        "owner": "serve/workload.py",
        "doc": "at import: record every terminal serve request to this JSONL base.",
    },
}
