"""value_update_ms: the program's host seconds staging device blocks
into matrices and merging them at `finalize` (regions ``matrix_stage``
and ``matrix_finalize``, `read_totals()["regions"]`): a step's new
operand values, and any merge inside the program; per step, in ms."""

NAMES = ("matrix_stage", "matrix_finalize")


def read(run):
    regions = run.counters.get("regions", {})
    found = [regions[n]["seconds"] for n in NAMES if n in regions]
    return sum(found) / run.steps * 1e3 if found and run.steps else None
