"""Split-factor heuristics: a copy of `dbcsr_tpu/tas/split.py`.

Ref `dbcsr_tas_mm.F:1427-1464` (split factor from nnz ratios) and
`dbcsr_tas_split.F:207-281` (nsplit acceptance).  The split factor
estimates how much longer the long dimension is than the short ones,
weighted by data so a sparse long dimension doesn't over-split.
"""

from __future__ import annotations

import numpy as np


def estimate_split_factor(m_full: int, n_full: int, k_full: int,
                          nnz_a: int, nnz_b: int, nnz_c: int) -> float:
    """Ratio long/short weighted by occupancy (ref split_factor_estimate)."""
    dims = sorted([m_full, n_full, k_full])
    short = max(1, int(np.sqrt(dims[0] * dims[1])))
    long_ = dims[2]
    geom = long_ / short
    # damp by relative fill of the long matrix: nearly-empty long
    # dimensions don't need splitting
    total = max(1, nnz_a + nnz_b + nnz_c)
    dense_total = max(1, m_full * k_full + k_full * n_full + m_full * n_full)
    fill = min(1.0, 3.0 * total / dense_total)
    return max(1.0, geom * max(fill, 0.05))


def choose_nsplit(split_factor: float, ngroups_max: int, nblks_long: int) -> int:
    """Accept an nsplit near the split factor, bounded by available
    groups and the block count of the long dimension
    (ref accept_pgrid/nsplit heuristics, dbcsr_tas_split.F:207-281)."""
    n = int(round(split_factor))
    n = max(1, min(n, ngroups_max, nblks_long))
    return n


def estimate_split_traffic(long_dim: str, nsplit: int, n_el_a: int,
                           n_el_b: int, n_el_c_est: float, itemsize: int,
                           kl: int, s: int) -> float:
    """Modeled collective bytes of one mesh TAS multiply at ``nsplit``.

    Calibrated against the virtual-mesh traffic counters
    (`tests/test_tas.py::test_nsplit_traffic_optimal`, measuring the
    `core/stats` ppermute/psum meters):

    * plain path (nsplit=1, or k-long): the full Cannon ring-shifts
      both operands s ticks, and kl>1 layers psum the C panels;
    * grouped m/n-long path: each of the nsplit groups Cannon-shifts
      its slice of the long operand plus a REPLICA of the short one —
      replication is the per-split cost
      (ref `redistribute_and_sum`, `dbcsr_tas_mm.F:783`).
    """
    if nsplit <= 1 or long_dim == "k":
        t = s * (n_el_a + n_el_b) * itemsize
        if kl > 1:
            t += (kl - 1) * n_el_c_est * itemsize
        return t
    rep, sl = (n_el_b, n_el_a) if long_dim == "m" else (n_el_a, n_el_b)
    return s * (sl + nsplit * rep) * itemsize


def choose_nsplit_traffic(long_dim: str, m_full: int, n_full: int,
                          k_full: int, nnz_a: int, nnz_b: int, nnz_c: int,
                          itemsize: int, kl: int, s: int, ngroups_max: int,
                          nblks_long: int, slack: float = 1.1):
    """Traffic-optimal nsplit for the mesh TAS path: argmin of the
    modeled bytes-moved, tie-broken toward the LARGEST split within a
    ``slack`` window of the minimum (replication that is nearly free
    buys group parallelism).  Returns None when nsplit does not affect
    traffic (k-long products, or kl=1 meshes where grouping cannot
    engage) — callers keep the geometric estimate there."""
    if long_dim == "k" or kl <= 1:
        return None
    pa = nnz_a / max(1, m_full * k_full)
    pb = nnz_b / max(1, k_full * n_full)
    c_est = nnz_c if nnz_c else min(1.0, pa * pb * k_full) * m_full * n_full
    gmax = max(1, min(ngroups_max, nblks_long))
    traffic = {
        g: estimate_split_traffic(long_dim, g, nnz_a, nnz_b, c_est,
                                  itemsize, kl, s)
        for g in range(1, gmax + 1)
    }
    tmin = min(traffic.values())
    return max(g for g, t in traffic.items() if t <= slack * tmin)
