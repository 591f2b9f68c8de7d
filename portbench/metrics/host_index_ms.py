"""host_index_ms: the program's host seconds in the multiply's "index"
phase (`read_totals()["host_phase_s"]`), per multiply, in ms."""


def read(run):
    n = run.counters.get("multiplies", 0)
    s = run.counters.get("host_phase_s", {}).get("index")
    return s / n * 1e3 if n and s is not None else None
