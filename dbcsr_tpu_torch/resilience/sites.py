"""Registry of the fault-injection sites the port has.

A copy of `dbcsr_tpu/resilience/sites.py`, limited to the sites that
exist in the port: the stack launch, the fused C-bin launch, the stack
planning, the canvas (dense and composite) formats, the storage-format
planner, the incremental splice, the grid engines' world join,
dispatch and tick edges, the tenant billing window and the online
tuner's trials.  The JAX package's probe, serving and fleet sites come
back with their modules (`ROADMAP.md`, Queue 1).  Every literal site the port passes to `faults.maybe_inject`
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
    "execute_superstack": {
        "boundary": "`acc.smm.execute_superstack` per fused C-bin launch",
        # corruption honoured at the fused boundary, kept out of the
        # randomized chaos draw as in the JAX package
        "corruptible": True, "chaos": False, "dynamic": False,
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
    "format_plan": {
        "boundary": "the storage-format planner's decision "
                    "(`mm.format_planner.choose`): a fault degrades the "
                    "plan to the stack format for that product only, never "
                    "cached (label `name`)",
        "corruptible": False, "chaos": True, "dynamic": False,
    },
    "incremental": {
        "boundary": "`mm.incremental._execute_splice` (the delta-aware "
                    "partial recompute + splice; raise/oom abort it, "
                    "nan/flip corrupt the assembled C for the full-product "
                    "probe to catch)",
        "corruptible": True, "chaos": True, "dynamic": False,
    },
    "multihost_init": {
        "boundary": "`parallel.multihost.init_multihost` (the world join)",
        # a multi-process join cannot fire inside a one-process chaos run
        "corruptible": False, "chaos": False, "dynamic": False,
    },
    "collective": {
        "boundary": "`parallel.sparse_dist` grid dispatch boundary (before "
                    "any panel moves: the product raises, nothing is written)",
        "corruptible": False, "chaos": False, "dynamic": False,
    },
    "mesh_shift": {
        "boundary": "the double-buffered Cannon tick/shift boundary "
                    "(`parallel.overlap.run_ticks`, one per shift; labels "
                    "`engine`, `tick`)",
        "corruptible": True, "chaos": True, "dynamic": True,
    },
    "gather_chunk": {
        "boundary": "the chunked all-gather pipeline's per-shard step on "
                    "rectangular grids (same `run_ticks` edge, breaker "
                    "`gather_pipe`; labels `engine`, `tick`)",
        "corruptible": True, "chaos": True, "dynamic": True,
    },
    "tas_tick": {
        "boundary": "the grouped-TAS metronome's tick/shift edge (breaker "
                    "`cannon_db` keyed engine=\"tas\")",
        "corruptible": True, "chaos": True, "dynamic": True,
    },
    "attribution": {
        "boundary": "`obs.attribution.bill_window` (the tenant billing "
                    "path): observable, never unbalances the books or "
                    "fails a request (labels `requests`, `request_id`)",
        "corruptible": False, "chaos": True, "dynamic": False,
    },
    "tune_trial": {
        "boundary": "the online tuner's trial boundary (`tune.trials`, one "
                    "per candidate sweep or format trial; labels `mnk`, "
                    "`dtype`): a fault aborts the trial and nothing is "
                    "promoted from it",
        "corruptible": False, "chaos": True, "dynamic": False,
    },
}

# driver labels a fault spec's *target* may also match at a site
# (``pallas:nan`` fires on execute_stack launches of the base kernel):
# the config's driver names, as the breakers and counters use them
DRIVER_TARGETS = ("pallas_cross", "pallas", "torch", "host")


def chaos_sites() -> tuple:
    """The targets a randomized chaos schedule draws from: every
    ``chaos`` site and the driver labels."""
    return tuple(s for s, meta in SITES.items() if meta["chaos"]) + DRIVER_TARGETS


def chaos_corrupt_targets() -> tuple:
    """The targets whose output a nan/flip spec can corrupt in such a
    schedule: the corruptible chaos sites and the driver labels."""
    return tuple(s for s, meta in SITES.items()
                 if meta["chaos"] and meta["corruptible"]) + DRIVER_TARGETS
