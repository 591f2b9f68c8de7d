"""host_plan_ms: the program's host seconds finding the product's plan
in the plan cache, or building it on a miss (region ``multiply_plan``,
`read_totals()["regions"]`), per multiply, in ms."""


def read(run):
    n = run.counters.get("multiplies", 0)
    r = run.counters.get("regions", {}).get("multiply_plan")
    return r["seconds"] / n * 1e3 if n and r else None
