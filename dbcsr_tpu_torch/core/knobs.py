"""Registry of every ``DBCSR_TPU_TORCH_*`` environment variable the port
reads, with the module that reads it and what it does.

Counterpart of `dbcsr_tpu/core/knobs.py`: pure data, no imports.
`tests/test_torch_knobs.py` holds the sources to it: every
``DBCSR_TPU_TORCH_*`` literal in `dbcsr_tpu_torch/` and `chip_smoke.py`
is an entry here, and every entry is read somewhere.  The config's
fields (`core/config.py`) have no environment variable.
"""

KNOBS = {
    "DBCSR_TPU_TORCH_BREAKER_COOLDOWN_S": {
        "owner": "resilience/breaker.py",
        "doc": "seconds an open breaker waits before its half-open trial.",
    },
    "DBCSR_TPU_TORCH_BREAKER_THRESHOLD": {
        "owner": "resilience/breaker.py",
        "doc": "consecutive failures that open a (driver, shape) breaker.",
    },
    "DBCSR_TPU_TORCH_CHECK_OUTPUTS": {
        "owner": "acc/smm.py",
        "doc": "=1 at import: a finite-output check after every stack launch.",
    },
    "DBCSR_TPU_TORCH_EVENTS": {
        "owner": "obs/events.py",
        "doc": "base path of the event bus's JSONL sink (one shard per "
               "process); 0 or off turns the bus off.",
    },
    "DBCSR_TPU_TORCH_FAULTS": {
        "owner": "resilience/faults.py",
        "doc": "fault-injection specs (the JAX package's DSL), read on first use.",
    },
    "DBCSR_TPU_TORCH_MULTIHOST_TIMEOUT_S": {
        "owner": "parallel/multihost.py",
        "doc": "seconds `init_multihost` waits for the world's rendezvous "
               "before it degrades to serial (default 300).",
    },
    "DBCSR_TPU_TORCH_NATIVE": {
        "owner": "native/__init__.py",
        "doc": "=0 runs the multiply's index build and sort on the NumPy "
               "path instead of the native engine.",
    },
    "DBCSR_TPU_TORCH_PARAMS_DIR": {
        "owner": "acc/params.py",
        "doc": "directory of the tuned parameter table.",
    },
    "DBCSR_TPU_TORCH_PEAK_GBS": {
        "owner": "obs/costmodel.py",
        "doc": "device memory bandwidth (GB/s) the roofline uses in place of "
               "the peak table's.",
    },
    "DBCSR_TPU_TORCH_PEAK_GFLOPS": {
        "owner": "obs/costmodel.py",
        "doc": "peak compute (GFLOP/s, every dtype) the roofline uses in place "
               "of the peak table's.",
    },
    "DBCSR_TPU_TORCH_POOL": {
        "owner": "core/mempool.py",
        "doc": "=0 turns the device buffer pool and the residency of "
               "filtered plans off.",
    },
    "DBCSR_TPU_TORCH_ROOFLINE": {
        "owner": "obs/costmodel.py",
        "doc": "JSON dict of peak rows merged over the roofline table.",
    },
    "DBCSR_TPU_TORCH_SYNC_TIMING": {
        "owner": "core/stats.py",
        "doc": "=1: the engine synchronizes the card after each launch, so the "
               "statistics' seconds are device seconds.",
    },
    "DBCSR_TPU_TORCH_TRACE": {
        "owner": "obs/tracer.py",
        "doc": "base path of the span tracer's JSONL (one shard per process; "
               "the Chrome trace lands beside it).",
    },
}
