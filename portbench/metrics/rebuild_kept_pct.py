"""rebuild_kept_pct: the stack multiplies that kept C's bins (C already
held every key of the product, at beta 1) over those that kept or
rebuilt them (`read_totals()["c_rebuild"]`), in %; none where the
program does not count them."""


def read(run):
    counts = run.counters.get("c_rebuild")
    total = counts["kept"] + counts["rebuilt"] if counts else 0
    return 100.0 * counts["kept"] / total if total else None
