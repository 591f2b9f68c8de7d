"""products_roofline: the least device time of the window's block
products (`portbench/peaks.py`: true flops over the published peak, or
least bytes over the peak bandwidth, whichever is larger, per step)
over the device's busy time in the window (the union of its operations'
intervals in the `torch.profiler` trace), in %."""

from portbench import peaks


def read(run):
    ts = run.trace_summary
    if ts is None or ts["busy_s"] is None:
        return None
    return peaks.roofline_pct(run.state.least_s * run.steps, ts["busy_s"])
