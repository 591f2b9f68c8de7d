"""Content digests and identity keys: how the port's caches key values.

The port's own copy of `dbcsr_tpu/core/digests.py`:

* content digests (`digest`, `host_digest`, `index_digest`): sha1 over
  raw bytes (shape- and dtype-qualified in `host_digest`), for keys that
  must survive across objects: candidate lists, patterns, value keys;
* `scalar_key`: one key for a scalar however it is typed;
* `buffers_key`: the identity of a sequence of tensors, for a cache that
  holds them (an id is reused once its tensor is gone).  The port's
  tensors are mutable, so a cache keyed on identity also checks each
  tensor's ``_version`` (as the norm memo and the canvas cache do);
* value digests of matrices (`bin_value_digest`, `matrix_value_digest`):
  a bin's content hash memoized on the tensor's identity and version,
  and a matrix's memoized on its mutation epoch
  (`BlockSparseMatrix.mutation_epoch`) and its bins' versions.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Tuple

import numpy as np


def digest(*chunks: bytes) -> bytes:
    """sha1 over the concatenated byte chunks."""
    h = hashlib.sha1()
    for c in chunks:
        h.update(c)
    return h.digest()


def host_digest(arr) -> bytes:
    """Content digest of one host array, qualified by its dtype and shape
    (a (2, 3) and a (3, 2) view of the same bytes differ)."""
    arr = np.ascontiguousarray(arr)
    return digest(str(arr.dtype).encode(), np.asarray(arr.shape, np.int64).tobytes(),
                  arr.tobytes())


def index_digest(*arrays) -> bytes:
    """Digest of a fixed-arity tuple of host index arrays (candidate
    lists, key vectors).  Shape-unqualified: the caller's arity and
    order are part of its contract."""
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


def scalar_key(x) -> complex:
    """A cache key for a scalar: Python floats, numpy scalars and 0-d
    arrays of one value key alike."""
    return complex(x)


def buffers_key(arrays) -> Tuple[int, ...]:
    """Identity key of a sequence of tensors; the cache storing it must
    hold the tensors too."""
    return tuple(id(a) for a in arrays)


# id(tensor) -> (tensor, version, count, digest, nbytes): the memo holds
# the tensor, so it pins device memory and is bounded by bytes too
_bin_memo: "OrderedDict[int, tuple]" = OrderedDict()
_bin_memo_bytes = 0
_BIN_MEMO_MAX = 256
_BIN_MEMO_MAX_BYTES = 128 * 1024 * 1024


def bin_value_digest(data, count: int) -> bytes:
    """Content digest of one bin's first ``count`` blocks, memoized on the
    tensor's identity and version; a miss fetches them to the host
    (counted by `mempool.record_d2h`)."""
    from dbcsr_tpu_torch.core import mempool
    from dbcsr_tpu_torch.core.matrix import to_host

    global _bin_memo_bytes
    key = id(data)
    hit = _bin_memo.get(key)
    if hit is not None and hit[0] is data and hit[1] == data._version and hit[2] == count:
        _bin_memo.move_to_end(key)
        return hit[3]
    host = to_host(data[:count])
    mempool.record_d2h(host.nbytes)
    d = host_digest(host)
    nbytes = data.numel() * data.element_size()
    if hit is not None:
        _bin_memo_bytes -= hit[4]
    _bin_memo[key] = (data, data._version, count, d, nbytes)
    _bin_memo_bytes += nbytes
    while len(_bin_memo) > 1 and (len(_bin_memo) > _BIN_MEMO_MAX
                                  or _bin_memo_bytes > _BIN_MEMO_MAX_BYTES):
        _, old = _bin_memo.popitem(last=False)
        _bin_memo_bytes -= old[4]
    return d


def matrix_value_digest(m) -> bytes:
    """Value digest of a finalized matrix: its pattern fingerprint, dtype
    and every bin's content, memoized on the matrix by its mutation
    epoch (every value funnel bumps it) and its bins' identities and
    versions (a write into a bin tensor that no funnel saw)."""
    held = tuple((id(b.data), b.data._version) for b in m.bins)
    cached = getattr(m, "_value_digest_cache", None)
    if cached is not None and cached[0] == m.mutation_epoch and cached[2] == held:
        return cached[1]
    parts = [repr(m.pattern_fingerprint()).encode(), str(m.dtype).encode()]
    for b in m.bins:
        parts.append(np.asarray((b.shape[0], b.shape[1], b.count), np.int64).tobytes())
        if b.count:
            parts.append(bin_value_digest(b.data, b.count))
    d = digest(*parts)
    m._value_digest_cache = (m.mutation_epoch, d, held)
    return d


def clear() -> None:
    """Drop the per-bin digest memo."""
    global _bin_memo_bytes
    _bin_memo.clear()
    _bin_memo_bytes = 0
