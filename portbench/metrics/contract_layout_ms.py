"""contract_layout_ms: the program's host seconds in the contraction's
layout work around its TAS multiply: the operands' restriction and
remaps into matrix layouts and the copy of the result into C's mapping
(regions ``tensor_restrict``, ``tensor_remap`` and ``tensor_copy``,
`read_totals()["regions"]`), per step, in ms."""

NAMES = ("tensor_restrict", "tensor_remap", "tensor_copy")


def read(run):
    regions = run.counters.get("regions", {})
    found = [regions[n]["seconds"] for n in NAMES if n in regions]
    return sum(found) / run.steps * 1e3 if found and run.steps else None
