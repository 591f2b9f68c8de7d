"""index_expand_ms: the program's host seconds in the expansion of the
symbolic product, the first part of the multiply's "index" (its
`core.timings` region ``multiply_index_expand``, `read_totals()["regions"]`),
per multiply, in ms."""


def read(run):
    n = run.counters.get("multiplies", 0)
    r = run.counters.get("regions", {}).get("multiply_index_expand")
    return r["seconds"] / n * 1e3 if n and r else None
