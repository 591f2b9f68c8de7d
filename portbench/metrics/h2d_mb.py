"""h2d_mb: the bytes the program uploaded from the host to the device
(index arrays and host blocks; `read_totals()["h2d_bytes"]`, the
counter of `core.mempool.record_h2d`), per step, in MB (1e6 bytes)."""


def read(run):
    b = run.counters.get("h2d_bytes")
    return b / 1e6 / run.steps if b is not None and run.steps else None
