"""A program's answer as the reference reads it."""

from __future__ import annotations

import numpy as np


def output_groups(c) -> list:
    """A block-sparse matrix's blocks, by shape: [((bm, bn), sorted keys,
    slots, data)], block ``keys[i]`` lying at ``data[slots[i]]``."""
    out = []
    for b, bn in enumerate(c.bins):
        sel = np.nonzero(c.ent_bin == b)[0]
        out.append((tuple(bn.shape), c.keys[sel], c.ent_slot[sel].astype(np.int64), bn.data))
    return out
