"""index_plan_key_ms: the program's host seconds in the plan-cache key,
the third part of the multiply's "index" (C's pattern fingerprint and
the key of the operands' fingerprints; region ``multiply_plan_key``,
entered twice a multiply, `read_totals()["regions"]`), per multiply, in
ms."""


def read(run):
    n = run.counters.get("multiplies", 0)
    r = run.counters.get("regions", {}).get("multiply_plan_key")
    return r["seconds"] / n * 1e3 if n and r else None
