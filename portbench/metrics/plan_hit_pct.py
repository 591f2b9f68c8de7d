"""plan_hit_pct: the plan cache's hits over its lookups in the window
(`read_totals()["plan_cache"]`), in %."""


def read(run):
    pc = run.counters.get("plan_cache", {})
    lookups = sum(pc.values())
    return 100.0 * pc.get("hit", 0) / lookups if lookups else None
