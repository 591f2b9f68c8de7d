"""launches_per_multiply: device operations launched inside the
benchmark's span around its call into the program, per multiply the
program ran, from the `torch.profiler` trace."""


def read(run):
    ts, n = run.trace_summary, run.counters.get("multiplies", 0)
    if ts is None or ts["busy_s"] is None or not n:
        return None
    return ts["launches"][run.state.entry] / n
