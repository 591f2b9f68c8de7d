"""peak_mem_gb: the caching allocator's peak of allocated bytes over the
window (`torch.cuda.max_memory_allocated`, reset at the window's start),
in GB (1e9 bytes)."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.window_peak_bytes / 1e9
