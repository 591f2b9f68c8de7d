"""index_keys_ms: the program's host seconds in C's new keys, the
second part of the multiply's "index" (the candidates' `np.unique` and
their union with C's keys, or the mask of a product that keeps C's
pattern; region ``multiply_index_keys``, `read_totals()["regions"]`), per
multiply, in ms."""


def read(run):
    n = run.counters.get("multiplies", 0)
    r = run.counters.get("regions", {}).get("multiply_index_keys")
    return r["seconds"] / n * 1e3 if n and r else None
