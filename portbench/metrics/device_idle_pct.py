"""device_idle_pct: the share of the traced window that no device
operation covers (the complement of the union of their intervals in the
`torch.profiler` trace), in %."""


def read(run):
    ts = run.trace_summary
    if ts is None or ts["busy_s"] is None or ts["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ts["busy_s"] / ts["window_s"])
