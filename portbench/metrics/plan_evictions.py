"""plan_evictions: the plans the plan cache evicted, over its entry cap
and over its byte cap together (`read_totals()["plan_evictions"]`, which
also names the cause of each and the bytes they pinned), per
multiply."""


def read(run):
    n = run.counters.get("multiplies", 0)
    ev = run.counters.get("plan_evictions")
    return (ev["entries"] + ev["bytes"]) / n if n and ev is not None else None
