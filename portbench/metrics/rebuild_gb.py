"""rebuild_gb: the device bytes of C's rebuilds in the multiplies, the
new bins allocated plus the old blocks moved into them
(`read_totals()["rebuild_bytes"]`, reckoned on the host from counts and
shapes), per step, in GB (1e9 bytes)."""


def read(run):
    rb = run.counters.get("rebuild_bytes")
    if rb is None or not run.steps or not run.counters.get("multiplies"):
        return None
    return (rb["allocated"] + rb["moved"]) / 1e9 / run.steps
