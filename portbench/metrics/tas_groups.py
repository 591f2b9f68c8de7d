"""tas_groups: the multiplies the program ran per step (a contraction's
TAS split groups), from its own counter (`read_totals()["multiplies"]`)."""


def read(run):
    n = run.counters.get("multiplies", 0)
    return n / run.steps if run.steps and n else None
