"""What the benchmark reads from the program under test: its counters.

The multiply engine keeps totals since its last reset
(`dbcsr_tpu_torch.mm.multiply.read_totals`): multiplies, host seconds
per phase ("index", "assemble", ...), plan-cache outcomes.  The caching
allocator counts its retries (`torch.cuda.memory_stats`).
"""

from __future__ import annotations

import torch

from dbcsr_tpu_torch.mm import multiply as _mm


def reset_counters() -> None:
    _mm.reset_totals()


def read_counters() -> dict:
    return _mm.read_totals()


def alloc_retries(device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(device).get("num_alloc_retries", 0))
