"""Registry of the fault-injection sites the port has.

A copy of `dbcsr_tpu/resilience/sites.py`, limited to the sites that
exist in the port: the stack launch, the stack planning, the canvas
(dense and composite) formats and the incremental splice.  The JAX
package's superstack, format planner, mesh, TAS tick, probe,
attribution, serving, fleet and tuner sites come back with their
modules (`ROADMAP.md`, Queue 1).  Every literal site the port passes to `faults.maybe_inject`
or `faults.corrupt` is registered here (`tests/test_torch_resilience.py`
checks the sources).

Fields per site: ``boundary`` (where it fires), ``corruptible``
(honours nan/flip output corruption), ``chaos`` (drawn by the JAX
package's randomized chaos schedule) and ``dynamic`` (the site name
reaches the injection call through a variable).
"""

SITES = {
    "execute_stack": {
        "boundary": "`acc.smm.execute_stack` per driver launch",
        "corruptible": True, "chaos": True, "dynamic": False,
    },
    "prepare_stack": {
        "boundary": "`acc.smm.prepare_stack` (host-side planning)",
        "corruptible": False, "chaos": True, "dynamic": False,
    },
    "dense": {
        "boundary": "the canvas paths in `mm.multiply` (whole-panel "
                    "dense AND the batched composite panels share this "
                    "site: one failover, one corruption hook)",
        "corruptible": True, "chaos": True, "dynamic": False,
    },
    "incremental": {
        "boundary": "`mm.incremental._execute_splice` (the delta-aware "
                    "partial recompute + splice; raise/oom abort it, "
                    "nan/flip corrupt the assembled C for the full-product "
                    "probe to catch)",
        "corruptible": True, "chaos": True, "dynamic": False,
    },
}

# driver labels a fault spec's *target* may also match at a site
# (``pallas:nan`` fires on execute_stack launches of the base kernel):
# the config's driver names, as the breakers and counters use them
DRIVER_TARGETS = ("pallas_cross", "pallas", "torch", "host")
