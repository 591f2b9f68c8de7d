"""alloc_retries: the caching allocator's retries (a cudaMalloc that
failed, the cache freed, and the call retried; `num_alloc_retries` of
`torch.cuda.memory_stats`) per step of the window."""


def read(run):
    if run.device.type != "cuda" or not run.steps:
        return None
    return run.alloc_retries / run.steps
