"""tas_prebuild_ms: the program's host seconds building C's final
pattern once before a TAS split's groups (region ``tas_c_prebuild``,
`read_totals()["regions"]`: the expansion of the whole product, the key
union and C's one rebuild), per step, in ms; none where the program has
no such region."""


def read(run):
    r = run.counters.get("regions", {}).get("tas_c_prebuild")
    return r["seconds"] / run.steps * 1e3 if r and run.steps else None
