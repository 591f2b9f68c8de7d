"""union_bitmap_pct: the multiplies' unions of C's old keys with the
candidates' keys that took the presence bitmap over C's key space, over
all of them in the window (`read_totals()["index_engine"]["union"]`), in
%; none where the program does not count its unions."""


def read(run):
    union = run.counters.get("index_engine", {}).get("union")
    total = sum(union.values()) if union else 0
    return 100.0 * union["bitmap"] / total if total else None
