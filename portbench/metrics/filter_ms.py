"""filter_ms: the program's host seconds in the multiply's filter: the
reads of the operands' block norms for the on-the-fly filter (region
``multiply_filter_norms``, inside "index") and C's post-filter (region
``multiply_filter``), `read_totals()["regions"]`, per multiply, in ms;
none where the program does not time its norm reads."""


def read(run):
    n = run.counters.get("multiplies", 0)
    regions = run.counters.get("regions", {})
    norms = regions.get("multiply_filter_norms")
    if not n or norms is None:
        return None
    post = regions.get("multiply_filter", {"seconds": 0.0})
    return (norms["seconds"] + post["seconds"]) / n * 1e3
