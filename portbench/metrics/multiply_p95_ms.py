"""multiply_p95_ms: the 95th percentile of every multiply's wall time in
the traced window, on the host clock, each call bracketed by
`torch.cuda.synchronize`."""

import statistics


def read(run):
    ms = run.call_ms.get("multiply", [])
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[18]
