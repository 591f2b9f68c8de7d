"""Cross-request coalescing: N same-structure products, one launch set.

Counterpart of `dbcsr_tpu/serve/coalesce.py`.  Requests whose
`coalesce_key` matches (equal A/B/C pattern fingerprints and dtypes,
scalars, trans flags, options) and that arrive within the batching
window run as ONE block-diagonal composite product

    diag(A_1..A_N) @ diag(B_1..B_N) = diag(C_1..C_N)

in a single `mm.multiply`: the composite has the same C shape bins as
one request, so the group pays one set of stack launches (K1's fused
`smm_superstack` per C bin, or K3 per span where the tuned table sends
the shape there) instead of N, and each tenant's C is carved back out on
the device.

**Bit for bit the standalone product.**  The composite's keys sort
product-major, so each C block's run -- its stack entries in A-entry
order -- is the standalone request's run with its indices shifted.
Every kernel sums a run in stack order and adds it to its C block
once: K1 and the fused launch give each run to one warp (or one tile)
in order, and K3's dealing of runs into packs by length moves whole
runs, so a composite that deals its runs differently from a single
request still sums each run alike.  The plain versions sum per run with
`index_add_` in stack order, whatever the chunk boundaries.  The carve
is an `index_select` of rows.

Coalescable are ``multiply`` requests on non-symmetric finalized
operands with no filter_eps (the norm filter depends on values), no
block or element limits and equal alpha/beta.  Everything else runs
serialized; correctness never depends on the window.  Unlike the JAX
package no bin is padded to a bucket size (a bin's capacity is its
count here), so the composite's bins are exactly the concatenations.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from dbcsr_tpu_torch.core import digests
from dbcsr_tpu_torch.core.kinds import name_of
from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY, BlockSparseMatrix, _Bin, _bin_entries
from dbcsr_tpu_torch.obs import attribution as _attr

LIMITS = ("first_row", "last_row", "first_col", "last_col", "first_k", "last_k",
          "element_limits")


class Unrecoverable(RuntimeError):
    """A coalesced group failed AFTER the carve started writing target C
    matrices with beta != 0: a serialized replay would apply beta to a C
    that is no longer the submitted one, so the engine fails the group
    instead of degrading it."""


def coalesce_key(op: str, params: dict) -> Optional[tuple]:
    """The cross-request batching key, or None when the request must run
    serialized.  Two requests with equal keys assemble into one
    block-diagonal composite."""
    if op != "multiply":
        return None
    if params.get("filter_eps") is not None or params.get("retain_sparsity"):
        return None
    if any(params.get(lim) is not None for lim in LIMITS):
        return None
    a, b, c = params["a"], params["b"], params["c"]
    for m in (a, b, c):
        if not isinstance(m, BlockSparseMatrix) or not m.valid:
            return None
        if m.matrix_type != NO_SYMMETRY:
            return None  # desymmetrizing is per request, not block-diagonal
    if not (a.device == b.device == c.device):
        return None
    try:
        # one scalar convention (core.digests) across the coalesce key,
        # the plan cache and the product cache
        alpha = digests.scalar_key(params.get("alpha", 1.0))
        beta = digests.scalar_key(params.get("beta", 0.0))
    except TypeError:
        return None
    return (
        str(params.get("transa", "N")).upper(),
        str(params.get("transb", "N")).upper(),
        alpha, beta,
        a.pattern_fingerprint(), b.pattern_fingerprint(), c.pattern_fingerprint(),
        name_of(a.dtype), name_of(b.dtype), name_of(c.dtype), str(c.device),
    )


def _composite(mats: List[BlockSparseMatrix], name: str) -> BlockSparseMatrix:
    """Block-diagonal composite of N same-pattern matrices, assembled on
    the device: per shape bin, the composite's data is the p-ordered
    `torch.cat` of every source bin (composite slot of source entry e of
    product p is ``p * count + slot(e)``: the composite keys sort
    product-major and `_bin_entries` assigns slots in key order)."""
    m0 = mats[0]
    n = len(mats)
    nbr, nbc = m0.nblkrows, m0.nblkcols
    rs = np.tile(m0.row_blk_sizes, n)
    cs = np.tile(m0.col_blk_sizes, n)
    comp = BlockSparseMatrix(name, rs, cs, m0.dtype, device=m0.device)
    if m0.nblks == 0:
        return comp
    rows0, cols0 = m0.entry_coords()
    nnbc = n * nbc
    keys = np.concatenate([(p * nbr + rows0) * nnbc + (p * nbc + cols0) for p in range(n)])
    rows = (keys // nnbc).astype(np.int64)
    cols = (keys % nnbc).astype(np.int64)
    nb, nsl, shapes = _bin_entries(rs, cs, rows, cols)
    by_shape = [{tuple(b.shape): b.data for b in m.bins} for m in mats]
    bins = []
    for bm, bn in shapes:
        shape = (int(bm), int(bn))
        parts = [d[shape] for d in by_shape]
        data = torch.cat(parts) if n > 1 else parts[0]
        bins.append(_Bin(shape, data, int(data.shape[0])))
    comp.set_structure_from_device(keys, bins, binning=(nb, nsl, shapes))
    return comp


def _split_composite(comp: BlockSparseMatrix, targets: List[BlockSparseMatrix]) -> None:
    """Carve the composite product back into each request's C (row
    copies on the device).  The block-diagonal structure is an invariant
    of the product -- A's p-stripe rows only meet B's p-stripe columns --
    checked here, never assumed."""
    from dbcsr_tpu_torch.core import mempool

    n = len(targets)
    t0 = targets[0]
    nbr, nbc = t0.nblkrows, t0.nblkcols
    nnbc = n * nbc
    rows = (comp.keys // nnbc).astype(np.int64)
    cols = (comp.keys % nnbc).astype(np.int64)
    p_row = rows // nbr
    p_col = cols // nbc
    if not np.array_equal(p_row, p_col):  # pragma: no cover - invariant
        raise RuntimeError("coalesced product left the block diagonal")
    for p, c in enumerate(targets):
        sel = np.nonzero(p_row == p)[0]
        local_keys = (rows[sel] - p * nbr) * nbc + (cols[sel] - p * nbc)
        lrows = (local_keys // nbc).astype(np.int64)
        lcols = (local_keys % nbc).astype(np.int64)
        nb, nsl, shapes = _bin_entries(c.row_blk_sizes, c.col_blk_sizes, lrows, lcols)
        bins = []
        for b_id, (bm, bn) in enumerate(shapes):
            esel = sel[nb == b_id]
            src_bin = comp.bins[comp.ent_bin[esel[0]]]
            idx = np.empty(len(esel), np.int64)
            idx[nsl[nb == b_id]] = comp.ent_slot[esel]
            data = src_bin.data.index_select(
                0, mempool.upload_index("serve_split", idx, device=src_bin.data.device))
            bins.append(_Bin((int(bm), int(bn)), data, len(esel)))
        c.set_structure_from_device(local_keys, bins, binning=(nb, nsl, shapes))


def execute_coalesced(requests: list) -> List[int]:
    """Run a group of coalesce-key-equal multiply requests as one
    block-diagonal composite multiply; returns each request's true flops
    (the composite's, split so that the shares sum to it exactly).
    Raising before the carve leaves every request's C untouched (the
    engine's degrade-to-serialized contract)."""
    from dbcsr_tpu_torch.core import mempool
    from dbcsr_tpu_torch.mm.multiply import multiply

    p0 = requests[0].params
    with mempool.chain() as ch:
        t0 = time.perf_counter()
        ca = _composite([r.params["a"] for r in requests], "serve:A")
        cb = _composite([r.params["b"] for r in requests], "serve:B")
        cc = _composite([r.params["c"] for r in requests], "serve:C")
        t_mul = time.perf_counter()
        flops = multiply(p0.get("transa", "N"), p0.get("transb", "N"),
                         p0.get("alpha", 1.0), ca, cb, p0.get("beta", 0.0), cc)
        t_carve = time.perf_counter()
        # every member's attribution row holds the group's host phases:
        # building the three composites ("compose"), the composite
        # multiply's own ("index", "assemble", "plan", "launch", ...) and
        # the carve
        _attr.group_phase(requests, "compose", t_mul - t0)
        for name, seconds in cc._mm_phase_s.items():
            _attr.group_phase(requests, name, seconds)
        try:
            _split_composite(cc, [r.params["c"] for r in requests])
        except Exception as exc:
            if complex(p0.get("beta", 0.0)) != 0:
                raise Unrecoverable(f"carve failed mid-group with beta != 0: "
                                    f"{type(exc).__name__}: {exc}") from exc
            raise
        finally:
            _attr.group_phase(requests, "carve", time.perf_counter() - t_carve)
        for m in (ca, cb, cc):
            ch.retire(m)
    # per-request true-flop shares: every member's product has the same
    # structure, so the split is even, but it must still SUM EXACTLY to
    # the composite's flops (attribution's conservation invariant): the
    # integer remainder lands on the first members
    n = len(requests)
    share, rem = divmod(int(flops), n)
    return [share + (1 if i < rem else 0) for i in range(n)]
