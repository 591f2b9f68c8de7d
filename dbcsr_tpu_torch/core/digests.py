"""Content digests: the hash the plan cache keys patterns and filtered
candidate lists by.

The port's own copy of `digest` and `index_digest` from
`dbcsr_tpu/core/digests.py:37-66` (sha1 over raw bytes).
"""

from __future__ import annotations

import hashlib

import numpy as np


def digest(*chunks: bytes) -> bytes:
    """sha1 over the concatenated byte chunks."""
    h = hashlib.sha1()
    for c in chunks:
        h.update(c)
    return h.digest()


def index_digest(*arrays) -> bytes:
    """Digest of a fixed-arity tuple of host index arrays (candidate
    lists, key vectors).  Shape-unqualified: the caller's arity and
    order are part of its contract."""
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()
