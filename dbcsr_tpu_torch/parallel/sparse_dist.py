"""Block-sparse Cannon over the ('kl','pr','pc') grid.

Counterpart of `dbcsr_tpu/parallel/sparse_dist.py`, the core re-design
of `multiply_cannon` (`dbcsr_mm_cannon.F:837`): device work and panel
traffic scale with the number of nonzero blocks, not the dense shape.

* `make_m2s` matrix->images predistribution (`dbcsr_mm_cannon.F:146,292`)
  -> each image's panel of zero-padded blocks, assembled on the device
  from the matrices' shape bins **at the Cannon-skewed position**, so
  the initial skew moves nothing.
* per-tick panel isend/irecv (:1420-1590) -> `Grid.shift` of the whole
  padded panel along 'pc' (A) and 'pr' (B), driven by `overlap.run_ticks`.
* the hash-based C-index build and stack fill (`dbcsr_mm_csr.F:178`)
  -> the full symbolic product on the host (the native index engine),
  carved into one parameter stack per (image, tick), sorted by C slot.
* per-thread multrec/stacks -> each (image, tick) stack runs through
  `acc.smm.prepare_stack`/`execute_stack`: on the card the hand-written
  kernels (K1, or K3 where the tuned table names it), on CPU tensors
  their plain versions.  The JAX package runs a tick as gather ->
  `dot_general` -> `segment_sum` in XLA; that is K1's function.
* 2.5D layers (`dbcsr_mm_3d.F`) -> the 'kl' axis partitions the k
  block range; C is completed by summing the layers in order 0..kl-1
  (ref `make_layers_3D_C_reduction`, `dbcsr_mm_3d.F:1037`).  Across
  ranks every rank gathers the layers' panels and sums them itself, so
  every rank returns the same C.

Mixed block sizes are exact through zero padding to the largest block
shape (bm, bk, bn), as in the JAX package: padded k columns of A meet
padded zero k rows of B.  Accumulation order is fixed (stacks sorted by
C slot, ticks in sequence, layers summed in order), so results are
bit-reproducible for a grid shape, across repeats, across the serial and
double_buffer modes, and between one process and several ranks.

Deliberate differences from the JAX layout: no capacity bucketing
(`bucket_size`) and no pad entries aimed at slot ``cap_c`` (a stack
holds its real entries only), no R-tiled stacks (`_stack_r0`, which
exists for the TPU's emulated f64), and no `shard_map` shims.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.core import stats
from dbcsr_tpu_torch.core.kinds import name_of
from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY, BlockSparseMatrix, _Bin, to_index
from dbcsr_tpu_torch.core.timings import timed
from dbcsr_tpu_torch.obs import costmodel as _costmodel
from dbcsr_tpu_torch.obs import events as _events
from dbcsr_tpu_torch.ops.transformations import desymmetrize
from dbcsr_tpu_torch.parallel import overlap as _overlap
from dbcsr_tpu_torch.parallel.cannon import ring_sources, shift_pair
from dbcsr_tpu_torch.parallel.mesh import Grid
from dbcsr_tpu_torch.resilience import faults as _faults


def adopt_panels(out: BlockSparseMatrix, keys: np.ndarray,
                 blocks: torch.Tensor) -> BlockSparseMatrix:
    """Carve (N, BM, BN) padded blocks (key order, on ``out``'s device)
    into ``out``'s shape bins (the collect half of `dbcsr_merge_all`,
    `dbcsr_work_operations.F:1393`)."""
    from dbcsr_tpu_torch.core.matrix import _bin_entries

    rows = (keys // out.nblkcols).astype(np.int64)
    cols = (keys % out.nblkcols).astype(np.int64)
    nb, nsl, shapes = _bin_entries(out.row_blk_sizes, out.col_blk_sizes, rows, cols)
    bins = []
    for b, (bm, bn) in enumerate(shapes):
        sel = np.nonzero(nb == b)[0]
        data = torch.empty((len(sel), bm, bn), dtype=out.dtype, device=out.device)
        data[to_index(nsl[sel], out.device)] = blocks[to_index(sel, blocks.device),
                                                      :bm, :bn].to(out.device, out.dtype)
        bins.append(_Bin((int(bm), int(bn)), data, len(sel)))
    out.set_structure_from_device(keys, bins, binning=(nb, nsl, shapes))
    return out


def _panel_slots(panel_ids: np.ndarray) -> np.ndarray:
    """Slot of each entry within its panel (entries in key order within
    equal panel ids)."""
    order = np.argsort(panel_ids, kind="stable")
    sorted_ids = panel_ids[order]
    starts = np.searchsorted(sorted_ids, sorted_ids)
    slots = np.empty(len(panel_ids), np.int64)
    slots[order] = np.arange(len(panel_ids)) - starts
    return slots


def _cap(panel_ids: np.ndarray, npanels: int) -> int:
    return max(int(np.bincount(panel_ids, minlength=npanels).max()), 1) if len(panel_ids) else 1


def _prepare_operands(matrix_a, matrix_b, matrix_c):
    """Shared prologue: desymmetrize, finalize, compatibility guards.
    Returns (a, b, matrix_c, dtype, bm, bk, bn)."""
    for m in (matrix_a, matrix_b, matrix_c):
        if m is not None and not m.valid:
            m.finalize()
    a = desymmetrize(matrix_a) if matrix_a.matrix_type != NO_SYMMETRY else matrix_a
    b = desymmetrize(matrix_b) if matrix_b.matrix_type != NO_SYMMETRY else matrix_b
    if matrix_c is not None and matrix_c.matrix_type != NO_SYMMETRY:
        matrix_c = desymmetrize(matrix_c)
    if not np.array_equal(a.col_blk_sizes, b.row_blk_sizes):
        raise ValueError("inner blockings differ")
    if matrix_c is not None and not (
            np.array_equal(matrix_c.row_blk_sizes, a.row_blk_sizes)
            and np.array_equal(matrix_c.col_blk_sizes, b.col_blk_sizes)):
        raise ValueError("C blocking incompatible with op(A), op(B)")
    if a.dtype != b.dtype or (matrix_c is not None and matrix_c.dtype != a.dtype):
        raise TypeError("dtypes of A/B/C differ")
    dtype = matrix_c.dtype if matrix_c is not None else a.dtype
    bm = int(a.row_blk_sizes.max()) if a.nblkrows else 1
    bk = int(a.col_blk_sizes.max()) if a.nblkcols else 1
    bn = int(b.col_blk_sizes.max()) if b.nblkcols else 1
    return a, b, matrix_c, dtype, bm, bk, bn


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """bfloat16 products accumulate in float32 (the acc layer's rule):
    the panels of a bfloat16 product are float32, which is exact."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _vcol(k: np.ndarray, kl: int, s: int):
    """k block -> (layer, panel column): the k axis is an image
    distribution of multiplicity kl over the s physical columns
    (`parallel/images.py`; ref `dbcsr_create_image_dist`)."""
    from dbcsr_tpu_torch.parallel.images import ImageDistribution

    return ImageDistribution(s, kl).split(k)


def _grid_map(dist_arr: Optional[np.ndarray], n: int, naxis: int) -> np.ndarray:
    """A block->grid-position map: the matrix's own distribution when it
    fits the grid axis, else cyclic decimation."""
    if dist_arr is not None and len(dist_arr) == n and (
            len(dist_arr) == 0
            or (dist_arr.min(initial=0) >= 0 and dist_arr.max(initial=0) < naxis)):
        return np.ascontiguousarray(dist_arr, np.int64)
    return np.arange(n, dtype=np.int64) % naxis


def _resolve_maps(a, b, matrix_c, pr: int, pc: int, kl: int):
    """Block->grid maps honoring the matrices' `Distribution`s (ref
    `dbcsr_distribution_new`, `dbcsr_dist_methods.F:49`): (rdist, cdist,
    k_layer, ka_col, kb_row).  Square grids need one k map shared by A's
    columns and B's rows (ref `dbcsr_mm.F:585-590`); rectangular grids
    (the all-gather engine) take independent k homes."""
    rdist = cdist = None
    for cand in ((matrix_c.dist if matrix_c is not None else None), a.dist):
        if cand is not None and cand.grid.nprows == pr:
            rdist = cand.row_dist
            break
    for cand in ((matrix_c.dist if matrix_c is not None else None), b.dist):
        if cand is not None and cand.grid.npcols == pc:
            cdist = cand.col_dist
            break
    nbk = a.nblkcols
    rdist = _grid_map(rdist, a.nblkrows, pr)
    cdist = _grid_map(cdist, b.nblkcols, pc)
    if pr == pc:
        s = pr
        kdist = None
        if a.dist.grid.npcols == s and len(a.dist.col_dist) == nbk:
            kdist = a.dist.col_dist
        elif b.dist.grid.nprows == s and len(b.dist.row_dist) == nbk:
            kdist = b.dist.row_dist
        if kdist is not None and (len(kdist) == 0 or (
                kdist.min(initial=0) >= 0 and kdist.max(initial=0) < s)):
            k_col = np.ascontiguousarray(kdist, np.int64)
            k_layer = _panel_slots(k_col) % kl
        else:
            k_layer, k_col = _vcol(np.arange(nbk, dtype=np.int64), kl, s)
        return rdist, cdist, k_layer, k_col, k_col
    ka = a.dist.col_dist if (a.dist.grid.npcols == pc and len(a.dist.col_dist) == nbk) else None
    kb = b.dist.row_dist if (b.dist.grid.nprows == pr and len(b.dist.row_dist) == nbk) else None
    ka_col = _grid_map(ka, nbk, pc)
    kb_row = _grid_map(kb, nbk, pr)
    k_layer = (np.arange(nbk, dtype=np.int64) // max(pr, pc)) % kl
    return rdist, cdist, k_layer, ka_col, kb_row


# --------------------------------------------------------------- assembly
@dataclasses.dataclass
class _Asm:
    """Where each stored block of an operand goes in a flat panel buffer:
    per bin, the in-bin source slots and the flat destinations."""

    bin_ids: tuple
    src_slots: tuple  # int64 tensors on the bins' device
    dst: tuple        # int64 tensors on the buffer's device
    nflat: int
    bm: int
    bn: int

    def nbytes(self) -> int:
        return sum(t.numel() * 8 for t in self.src_slots + self.dst)


def _make_asm(m: BlockSparseMatrix, flat: np.ndarray, keep: np.ndarray, nflat: int,
              bm: int, bn: int, device) -> _Asm:
    """`_Asm` from per-entry flat destinations (key order); ``keep``
    selects the entries this process assembles."""
    bin_ids, src, dst = [], [], []
    for b_id, bb in enumerate(m.bins):
        sel = np.nonzero((m.ent_bin == b_id) & keep)[0]
        if not len(sel):
            continue
        bin_ids.append(b_id)
        src.append(to_index(m.ent_slot[sel], bb.data.device))
        dst.append(to_index(flat[sel], device))
    return _Asm(tuple(bin_ids), tuple(src), tuple(dst), int(nflat), bm, bn)


def _run_asm(asm: _Asm, m: BlockSparseMatrix, dtype, device) -> torch.Tensor:
    """Scatter the operand's blocks into a zero (nflat, bm, bn) buffer."""
    out = torch.zeros((asm.nflat, asm.bm, asm.bn), dtype=dtype, device=device)
    for b_id, src, dst in zip(asm.bin_ids, asm.src_slots, asm.dst):
        data = m.bins[b_id].data
        out[dst, :data.shape[1], :data.shape[2]] = data[src].to(device, dtype)
    return out


def _bin_token(m: BlockSparseMatrix) -> tuple:
    """The identity and version of an operand's bins (the panel cache's
    key: bins are written in place, so the version counts too)."""
    return tuple((id(bb.data), bb.data._version) for bb in m.bins)


# ------------------------------------------------------------------ plans
@dataclasses.dataclass
class _MeshPlan:
    """Everything about a grid multiply that depends only on the
    operands' patterns, distributions, dtype and product options."""

    engine: str       # "cannon", "gather" or "tas"
    kl: int
    pr: int
    pc: int
    nticks: int
    cap_a: int        # A panel capacity (per image; "tas": q * cap of a group)
    cap_b: int
    cap_c: int        # C panel capacity ("tas": q * cap of a group)
    bm: int
    bk: int
    bn: int
    dtype: torch.dtype
    acc: torch.dtype
    true_flops: int
    n_cand: int
    stacks: dict      # (image, tick) -> (a, b, c) int64 host arrays, C-sorted
    a_asm: _Asm
    b_asm: _Asm
    cinit_asm: Optional[_Asm]
    has_window: bool
    inside_all: bool
    inside: Optional[torch.Tensor]  # (P, cap_c) or (P, cap_c, bm, bn) bool
    c_keys: np.ndarray
    c_binning: tuple
    collect: tuple    # per out bin: (flat positions tensor, count, shape)
    out_dist: object
    npanels_c: int    # C panels: pr*pc ("tas": kl*pr*pc)
    host_s: float = 0.0
    ngroups: int = 0
    stack_plans: dict = dataclasses.field(default_factory=dict)
    panel_cache: dict = dataclasses.field(default_factory=dict)

    def index_bytes(self) -> int:
        """Bytes of the index maps the plan placed on the device (its
        host-to-device traffic; a plan-cache hit uploads nothing)."""
        n = self.a_asm.nbytes() + self.b_asm.nbytes()
        if self.cinit_asm is not None:
            n += self.cinit_asm.nbytes()
        n += sum(int(pos.numel()) * 8 for pos, _, _ in self.collect)
        if self.inside is not None:
            n += self.inside.numel()
        return n

    def nbytes(self) -> int:
        n = self.index_bytes()
        n += sum(sum(x.nbytes for x in st) for st in self.stacks.values())
        n += sum(p.nbytes() for p in self.stack_plans.values() if p is not None)
        for _, buf, _ in self.panel_cache.values():
            n += buf.numel() * buf.element_size()
        return n


_mesh_plan_cache: "OrderedDict[tuple, _MeshPlan]" = OrderedDict()
_MESH_PLAN_MAX = 8
_MESH_PLAN_MAX_BYTES = 2 * 1024 ** 3


def clear_mesh_plans() -> None:
    """Release every cached grid plan and its panels."""
    _mesh_plan_cache.clear()


def _mesh_cache_evict() -> None:
    while len(_mesh_plan_cache) > _MESH_PLAN_MAX or (
            len(_mesh_plan_cache) > 1
            and sum(p.nbytes() for p in _mesh_plan_cache.values()) > _MESH_PLAN_MAX_BYTES):
        _mesh_plan_cache.popitem(last=False)


def _plan_lookup(key):
    plan = _mesh_plan_cache.get(key) if key is not None else None
    if plan is not None:
        _mesh_plan_cache.move_to_end(key)
    return plan


def _plan_insert(key, plan: _MeshPlan) -> None:
    if key is not None:
        _mesh_plan_cache[key] = plan
        _mesh_cache_evict()


def _config_token() -> tuple:
    """What a cached stack plan depends on beyond the patterns: the
    driver config, the tuned table and the precision state (the single
    device's plan-cache key, `mm/multiply.py:_plan_key`)."""
    from dbcsr_tpu_torch.acc import params
    from dbcsr_tpu_torch.acc import precision as _precision
    from dbcsr_tpu_torch.core.config import get_config

    cfg = get_config()
    return ((cfg.mm_driver, cfg.validate_kernels), params.params_path(),
            params.generation(), _precision.plan_token())


def _cached_panels(plan: _MeshPlan, which: str, m: BlockSparseMatrix, device) -> torch.Tensor:
    """The operand's flat panel buffer, assembled again only when its
    bins changed since the cached assembly."""
    token = _bin_token(m)
    hit = plan.panel_cache.get(which)
    if hit is not None and hit[0] == token:
        return hit[1]
    asm = plan.a_asm if which == "a" else plan.b_asm
    buf = _run_asm(asm, m, plan.acc, device)
    plan.panel_cache[which] = (token, buf, [bb.data for bb in m.bins])
    _mesh_cache_evict()
    return buf


def _split_stacks(group, st_a, st_b, st_c, nimg: int, nticks: int, keep_img) -> dict:
    """Sort the entries by (image, tick, C slot, A slot) and cut one
    stack per local (image, tick) (the host-side stack fill,
    `dbcsr_mm_accdrv.F:364-423`)."""
    from dbcsr_tpu_torch.mm.multiply import _sort_order

    order, bounds = _sort_order(group, nimg * nticks, st_c, st_a)
    st_a, st_b, st_c = st_a[order], st_b[order], st_c[order]
    out = {}
    for gi in np.nonzero(np.diff(bounds))[0]:
        img, t = divmod(int(gi), nticks)
        if keep_img[img]:
            s0, s1 = int(bounds[gi]), int(bounds[gi + 1])
            out[(img, t)] = (st_a[s0:s1], st_b[s0:s1], st_c[s0:s1])
    return out


def _collect_maps(a, b, c_rows, c_cols, c_flat_pos, device) -> tuple:
    from dbcsr_tpu_torch.core.matrix import _bin_entries

    nb, nsl, shapes = _bin_entries(a.row_blk_sizes, b.col_blk_sizes, c_rows, c_cols)
    collect = []
    for b_id, shape in enumerate(shapes):
        sel = np.nonzero(nb == b_id)[0]
        pos = np.empty(len(sel), np.int64)
        pos[nsl[sel]] = c_flat_pos[sel]
        collect.append((to_index(pos, device), len(sel), shape))
    return (nb, nsl, shapes), tuple(collect)


def _true_flops(a, b, rows_t, cols_t, k_t) -> int:
    return int(2 * np.sum(a.row_blk_sizes[rows_t].astype(np.int64)
                          * b.col_blk_sizes[cols_t] * a.col_blk_sizes[k_t]))


def _build_mesh_plan(a, b, matrix_c, grid: Grid, dtype, bm, bk, bn, limits,
                     retain_sparsity, filter_eps, beta_window=None) -> _MeshPlan:
    """The host half of a grid multiply: symbolic product, image and tick
    assignment, the stacks, the panel and collect maps.  Square grids get
    the skewed Cannon layout; rectangular grids the all-gather layout
    (stack entries index the 'pc'-gathered A / 'pr'-gathered B
    concatenations, ticks are shard-arrival chunks)."""
    from dbcsr_tpu_torch.core.dist import Distribution, ProcessGrid
    from dbcsr_tpu_torch.mm.multiply import _candidates, mask_in_sorted

    t0 = time.perf_counter()
    kl, pr, pc = grid.kl, grid.pr, grid.pc
    home = grid.home()
    nbc_c = b.nblkcols
    rows_t, cols_t, a_ent, b_ent = _candidates(a, b, filter_eps, limits=tuple(limits))
    old_keys = matrix_c.keys if matrix_c is not None else np.empty(0, np.int64)
    if retain_sparsity:
        ok = mask_in_sorted(rows_t * nbc_c + cols_t, old_keys)
        rows_t, cols_t, a_ent, b_ent = rows_t[ok], cols_t[ok], a_ent[ok], b_ent[ok]
    k_t = (a.keys % a.nblkcols).astype(np.int64)[a_ent]
    true_flops = _true_flops(a, b, rows_t, cols_t, k_t)

    cannon = pr == pc
    nticks = pr if cannon else max(pr, pc)
    rdist, cdist, k_layer, ka_col, kb_row = _resolve_maps(a, b, matrix_c, pr, pc, kl)
    i_dev, j_dev, layer = rdist[rows_t], cdist[cols_t], k_layer[k_t]

    ar, ac = a.entry_coords()
    a_panel = ((k_layer[ac] * pr) + rdist[ar]) * pc + ka_col[ac]  # (l, i, ka)
    a_slots = _panel_slots(a_panel)
    cap_a = _cap(a_panel, kl * pr * pc)
    br, bc = b.entry_coords()
    b_panel = ((k_layer[br] * pr) + kb_row[br]) * pc + cdist[bc]  # (l, kb, j)
    b_slots = _panel_slots(b_panel)
    cap_b = _cap(b_panel, kl * pr * pc)

    if retain_sparsity:
        c_keys = old_keys
    else:
        c_keys = np.union1d(old_keys, np.unique(rows_t * nbc_c + cols_t))
    c_rows = (c_keys // nbc_c).astype(np.int64)
    c_cols = (c_keys % nbc_c).astype(np.int64)
    c_panel = rdist[c_rows] * pc + cdist[c_cols]
    c_slots = _panel_slots(c_panel)
    cap_c = _cap(c_panel, pr * pc)
    ent_c = np.searchsorted(c_keys, rows_t * nbc_c + cols_t)

    if cannon:
        # the tick at which A's k column meets B's k row on image (i, j);
        # stacks index local panel slots
        tick_t = (ka_col[k_t] - i_dev - j_dev) % pr
        st_a, st_b = a_slots[a_ent], b_slots[b_ent]
    else:
        # all-gather: stacks index the concatenations, ticks are
        # shard-arrival chunks, forward-balanced across the eligible
        # ticks (the JAX package's schedule)
        dist_a = (ka_col[k_t] - j_dev) % pc
        dist_b = (kb_row[k_t] - i_dev) % pr
        arrive = np.maximum(dist_a, dist_b)
        dev_t = (layer * pr + i_dev) * pc + j_dev
        cnt = np.bincount(dev_t, minlength=kl * pr * pc)
        order_t = np.lexsort((c_slots[ent_c], arrive, dev_t))
        starts = np.concatenate([[0], np.cumsum(cnt)])[:-1]
        rank = np.empty(len(dev_t), np.int64)
        rank[order_t] = np.arange(len(dev_t)) - starts[dev_t[order_t]]
        pos = (rank * nticks) // np.maximum(cnt[dev_t], 1)
        tick_t = np.maximum(arrive, pos)
        st_a = ka_col[k_t] * cap_a + a_slots[a_ent]
        st_b = kb_row[k_t] * cap_b + b_slots[b_ent]
    nimg = kl * pr * pc
    keep_img = np.array([grid.local(g) for g in range(nimg)])
    local_index = np.full(nimg, -1, np.int64)
    local_index[keep_img] = np.arange(int(keep_img.sum()))
    group = ((layer * pr + i_dev) * pc + j_dev) * nticks + tick_t
    stacks = _split_stacks(group, st_a, st_b, c_slots[ent_c], nimg, nticks, keep_img)

    # panel assembly maps: Cannon panels start skewed, all-gather panels
    # sit at their k home column
    al, ai_, akc = a_panel // (pr * pc), (a_panel // pc) % pr, a_panel % pc
    a_img = (al * pr + ai_) * pc + ((akc - ai_) % pr if cannon else akc)
    a_asm = _make_asm(a, local_index[a_img] * cap_a + a_slots, keep_img[a_img],
                      int(keep_img.sum()) * cap_a, bm, bk, home)
    bl, bkr, bj = b_panel // (pr * pc), (b_panel // pc) % pr, b_panel % pc
    b_img = (bl * pr + ((bkr - bj) % pr if cannon else bkr)) * pc + bj
    b_asm = _make_asm(b, local_index[b_img] * cap_b + b_slots, keep_img[b_img],
                      int(keep_img.sum()) * cap_b, bk, bn, home)

    cinit_asm = None
    if matrix_c is not None and matrix_c.nblks:
        pos_old = np.searchsorted(c_keys, old_keys)
        cinit_asm = _make_asm(matrix_c, c_panel[pos_old] * cap_c + c_slots[pos_old],
                              np.ones(len(old_keys), bool), pr * pc * cap_c, bm, bn, home)

    # windowed beta: C blocks outside the limit window keep their values
    fr_l, lr_l, fc_l, lc_l = limits[:4]
    has_window = any(x is not None for x in (fr_l, lr_l, fc_l, lc_l))
    inside = np.ones(len(c_keys), bool)
    if has_window:
        for x, lo, hi in ((c_rows, fr_l, lr_l), (c_cols, fc_l, lc_l)):
            if lo is not None:
                inside &= x >= lo
            if hi is not None:
                inside &= x <= hi
    inside_dev = None
    if beta_window is not None:
        # element-granular window (unaligned limits): straddling C blocks
        # get a per-element mask, beta inside, 1 outside
        fr_e, lr_e, fc_e, lc_e = beta_window
        roff = np.concatenate([[0], np.cumsum(a.row_blk_sizes)]).astype(np.int64)
        coff = np.concatenate([[0], np.cumsum(b.col_blk_sizes)]).astype(np.int64)
        lo_r = np.clip(fr_e - roff[c_rows], 0, bm)
        hi_r = np.clip(lr_e - roff[c_rows] + 1, 0, bm)
        lo_c = np.clip(fc_e - coff[c_cols], 0, bn)
        hi_c = np.clip(lc_e - coff[c_cols] + 1, 0, bn)
        ri, ci = np.arange(bm)[None, :], np.arange(bn)[None, :]
        mrow = (ri >= lo_r[:, None]) & (ri < hi_r[:, None])
        mcol = (ci >= lo_c[:, None]) & (ci < hi_c[:, None])
        canvas = np.ones((pr * pc, cap_c, bm, bn), bool)
        canvas[c_panel, c_slots] = mrow[:, :, None] & mcol[:, None, :]
        inside_dev = torch.from_numpy(canvas).to(home)
        has_window = True
        inside = np.zeros(1, bool)  # the old values must stay on
    elif has_window and not inside.all():
        canvas = np.ones((pr * pc, cap_c), bool)
        canvas[c_panel, c_slots] = inside
        inside_dev = torch.from_numpy(canvas).to(home)

    c_binning, collect = _collect_maps(a, b, c_rows, c_cols, c_panel * cap_c + c_slots, home)
    out_dist = (matrix_c.dist if matrix_c is not None and matrix_c.dist.grid.nprows == pr
                and matrix_c.dist.grid.npcols == pc
                else Distribution(rdist.astype(np.int32), cdist.astype(np.int32),
                                  ProcessGrid(pr, pc, grid)))
    acc = _acc_dtype(dtype)
    return _MeshPlan(
        engine="cannon" if cannon else "gather", kl=kl, pr=pr, pc=pc, nticks=nticks,
        cap_a=cap_a, cap_b=cap_b, cap_c=cap_c, bm=bm, bk=bk, bn=bn, dtype=dtype, acc=acc,
        true_flops=true_flops, n_cand=len(rows_t), stacks=stacks, a_asm=a_asm, b_asm=b_asm,
        cinit_asm=cinit_asm, has_window=has_window, inside_all=bool(inside.all()),
        inside=inside_dev, c_keys=c_keys, c_binning=c_binning, collect=collect,
        out_dist=out_dist, npanels_c=pr * pc, host_s=time.perf_counter() - t0)


# ------------------------------------------------------------------ ticks
def _exec_stack(plan: _MeshPlan, img: int, t: int, c, a, b) -> None:
    """One (image, tick) stack through the acc layer: planned once per
    mesh plan (a repeat plans nothing), launched on every run."""
    from dbcsr_tpu_torch.acc.smm import execute_stack, prepare_stack

    st = plan.stacks.get((img, t))
    if st is None:
        return
    key = (img, t)
    if key not in plan.stack_plans:
        plan.stack_plans[key] = prepare_stack(c, a, b, *st)
    execute_stack(c, a, b, plan.stack_plans[key], alpha=1.0)


def _views(buf: torch.Tensor, grid: Grid, cap: int, shared_layers: bool = False) -> list:
    """Per-image views of a flat panel buffer of this process's images
    (``shared_layers``: one panel per (i, j), every layer sees it)."""
    out: list = [None] * grid.size
    li = 0
    for g in grid.local_images():
        if shared_layers:
            _, i, j = grid.coords(g)
            view = buf[(i * grid.pc + j) * cap:(i * grid.pc + j + 1) * cap]
        else:
            view = buf[li * cap:(li + 1) * cap]
            li += 1
        out[g] = view if view.device == grid.device_of(g) else view.to(grid.device_of(g))
    return out


def _acc_buffers(plan: _MeshPlan, grid: Grid) -> tuple:
    """A zero accumulator buffer for this process's images and its views."""
    n = len(grid.local_images())
    buf = torch.zeros((n * plan.cap_c, plan.bm, plan.bn), dtype=plan.acc, device=grid.home())
    return buf, _views(buf, grid, plan.cap_c)


def _cannon_ticks(plan: _MeshPlan, grid: Grid, a_buf, b_buf, mode: str, measure: bool,
                  timings: list, site: str = "mesh_shift") -> tuple:
    """The skewed Cannon (and the grouped TAS) tick loop: returns the
    accumulator buffer and its per-image views."""
    a_p = _views(a_buf, grid, plan.cap_a)
    b_p = _views(b_buf, grid, plan.cap_b, shared_layers=plan.engine == "tas")
    c_buf, c_p = _acc_buffers(plan, grid)
    src_a, src_b = ring_sources(grid, "a"), ring_sources(grid, "b")

    def shift(aa, bb):
        return shift_pair(grid, aa, bb, src_a, src_b)

    def tick(aa, bb, cc, t):
        for g in grid.local_images():
            _exec_stack(plan, g, t, cc[g], aa[g], bb[g])
        return cc

    engine = "tas" if plan.engine == "tas" else "mesh"
    c_p, shift_s, comp_s = _overlap.run_ticks(
        plan.nticks, a_p, b_p, c_p, shift, tick, mode=mode, engine=engine, measure=measure,
        site=site, world=grid.multiprocess)
    if measure:
        timings.append((shift_s, comp_s))
    return c_buf, c_p


def _gather_ticks(plan: _MeshPlan, grid: Grid, a_buf, b_buf, mode: str, measure: bool,
                  timings: list) -> tuple:
    """The chunked all-gather pipeline of rectangular grids: tick t writes
    the shard pair at ring distance t into each image's concatenations
    (A at column (j+t)%pc, B at row (i+t)%pr), then runs tick t's stack,
    whose entries reference only shards arrived by then."""
    pr, pc, cap_a, cap_b = plan.pr, plan.pc, plan.cap_a, plan.cap_b
    a_roll = _views(a_buf, grid, cap_a)
    b_roll = _views(b_buf, grid, cap_b)
    c_buf, c_p = _acc_buffers(plan, grid)
    cats = {g: (torch.zeros((pc * cap_a, plan.bm, plan.bk), dtype=plan.acc,
                            device=grid.device_of(g)),
                torch.zeros((pr * cap_b, plan.bk, plan.bn), dtype=plan.acc,
                            device=grid.device_of(g)))
            for g in grid.local_images()}
    src_a, src_b = ring_sources(grid, "a"), ring_sources(grid, "b")

    def shift(aa, bb):
        # the rolling panels move one position (A along 'pc', B along
        # 'pr'); an axis of extent 1 hands over
        return shift_pair(grid, aa, bb, src_a, src_b)

    def tick(aa, bb, cc, t):
        for g in grid.local_images():
            _, i, j = grid.coords(g)
            a_cat, b_cat = cats[g]
            ca, rb = (j + t) % pc, (i + t) % pr
            a_cat[ca * cap_a:(ca + 1) * cap_a] = aa[g]
            b_cat[rb * cap_b:(rb + 1) * cap_b] = bb[g]
            _exec_stack(plan, g, t, cc[g], a_cat, b_cat)
        return cc

    c_p, shift_s, comp_s = _overlap.run_ticks(
        plan.nticks, a_roll, b_roll, c_p, shift, tick, mode=mode, engine="mesh",
        measure=measure, driver=_overlap.GATHER_DRIVER, site="gather_chunk",
        world=grid.multiprocess)
    if measure:
        timings.append((shift_s, comp_s))
    return c_buf, c_p


def _reduce_layers(plan: _MeshPlan, grid: Grid, c_buf, c_p) -> torch.Tensor:
    """C's panels (pr*pc*cap_c, bm, bn): every image's accumulator
    gathered to this process, the layers summed in order 0..kl-1 ("tas":
    the groups' disjoint panels as they are)."""
    P = plan.npanels_c
    per_layer = P * plan.cap_c if plan.engine != "tas" else plan.kl * P * plan.cap_c
    if not grid.multiprocess and all(grid.device_of(g) == grid.home()
                                      for g in range(grid.size)):
        flat = c_buf  # every image's view is in image order in one buffer
    else:
        c_all = grid.gather_all(c_p)
        flat = torch.cat([c_all[g].to(grid.home()) for g in range(grid.size)])
    if plan.engine == "tas" or plan.kl == 1:
        return flat[:per_layer]
    out = flat[:per_layer]
    for l in range(1, plan.kl):
        out = out + flat[l * per_layer:(l + 1) * per_layer]
    return out


def _finish(plan: _MeshPlan, c: torch.Tensor, c_init, alpha, beta_fac) -> torch.Tensor:
    """alpha*C + beta_fac*C_in, cast to C's dtype (the JAX package's
    tail); without old values to keep only alpha*C."""
    if alpha != 1.0:
        c = c * alpha
    if c_init is not None:
        fac = beta_fac
        if fac.dim() == 2:
            fac = fac.reshape(-1)[:, None, None]
        else:
            fac = fac.reshape(-1, plan.bm, plan.bn)
        c = c + fac * c_init.to(plan.acc)
    return c.to(plan.dtype)


def _beta_factor(plan: _MeshPlan, beta, device):
    """The per-slot (or per-element) factor on C's old values: beta, and
    1 outside a limit window."""
    b = torch.tensor(beta, dtype=plan.acc, device=device)
    if plan.inside is not None:
        return torch.where(plan.inside, b, torch.ones((), dtype=plan.acc, device=device))
    return b.expand(plan.npanels_c, plan.cap_c)


def _run_engine(plan: _MeshPlan, grid: Grid, a_buf, b_buf, engine_name: str,
                site: str) -> tuple:
    """Decide the overlap mode and run the tick pipeline guarded; returns
    (C panels after the layer sum, the mode that ran)."""
    label = grid.label()
    gather = plan.engine == "gather"
    pipe_s = plan.nticks if gather else plan.pr
    driver = _overlap.GATHER_DRIVER if gather else _overlap.DRIVER
    if pipe_s > 1:
        model_fn = _costmodel.gather_chunk_model if gather else _costmodel.mesh_tick_model
        tickm = model_fn(plan.cap_a, plan.cap_b, plan.bm, plan.bk, plan.bn, plan.n_cand,
                         plan.nticks, grid.size, plan.dtype.itemsize,
                         name_of(plan.dtype))
        _overlap.publish_modeled(engine_name, label, tickm)
    mode, why = _overlap.resolve_mode(engine_name, label, pipe_s, plan.nticks, driver=driver)
    _overlap.publish_decision(engine_name, label, mode, why)
    def run(m, measure, timings):
        if gather:
            acc = _gather_ticks(plan, grid, a_buf, b_buf, m, measure, timings)
        else:
            acc = _cannon_ticks(plan, grid, a_buf, b_buf, m, measure, timings, site=site)
        return _reduce_layers(plan, grid, *acc)

    def serial_fn():
        return run("serial", False, [])

    measure = pipe_s > 1 and _overlap.measuring()
    if _overlap.use_split_pipeline(mode, why, measure):
        ran = {"mode": mode}

        def fallback():
            ran["mode"] = "serial"
            return serial_fn()

        out = _overlap.run_split_pipeline(engine_name, label, mode,
                                          lambda timings: run(mode, measure, timings),
                                          fallback, measure, driver=driver)
        return out, ran["mode"]
    return serial_fn(), "serial"


def _collect(plan: _MeshPlan, c_out: torch.Tensor, out: BlockSparseMatrix) -> None:
    """Carve C's panels into the output's shape bins."""
    bins = [_Bin((int(shape[0]), int(shape[1])),
                 c_out[pos][:, :int(shape[0]), :int(shape[1])].contiguous(), count)
            for pos, count, shape in plan.collect]
    out.set_structure_from_device(plan.c_keys, bins, binning=plan.c_binning)


def sparse_multiply_distributed(alpha, matrix_a: BlockSparseMatrix,
                                matrix_b: BlockSparseMatrix, beta,
                                matrix_c: Optional[BlockSparseMatrix], mesh: Grid,
                                name: Optional[str] = None, retain_sparsity: bool = False,
                                filter_eps: Optional[float] = None,
                                first_row=None, last_row=None, first_col=None, last_col=None,
                                first_k=None, last_k=None,
                                element_limits=None) -> BlockSparseMatrix:
    """C = alpha*A@B + beta*C on the grid ``mesh`` with block-sparse
    panels; returns a new matrix on the grid's home device (``matrix_c``
    is read, not written).  The block limits restrict the product as
    `mm.multiply.multiply`'s do; ``element_limits`` gives them at element
    granularity (crop + element-windowed beta); ``filter_eps`` and
    ``retain_sparsity`` follow the single-device engine (ref
    `dbcsr_mm_cannon.F:1098-1105`).  In a multi-process world every rank
    calls it with the same operands and returns the same C."""
    with _events.product_scope("mesh_multiply", name or f"{matrix_a.name}*{matrix_b.name}",
                               a=matrix_a.name, b=matrix_b.name):
        if _faults.active():
            # the grid dispatch boundary: a fault here fires before any
            # panel moves, so nothing is written and a retry is clean
            _faults.maybe_inject("collective")
        with timed("sparse_cannon"):
            return _sparse_multiply_impl(
                alpha, matrix_a, matrix_b, beta, matrix_c, mesh, name,
                (first_row, last_row, first_col, last_col, first_k, last_k),
                retain_sparsity=retain_sparsity, filter_eps=filter_eps,
                element_limits=element_limits)


def _record_traffic(plan: _MeshPlan, grid: Grid, itemsize: int) -> None:
    """Collective-traffic counters (ref count_mpi_statistics,
    `dbcsr_mm_common.F:135`), the JAX package's model: each Cannon tick
    shifts every image's A and B panel; the all-gather moves the other
    panels of each image's row/column once; the layer sum moves every
    C panel kl - 1 times."""
    kl, pr, pc, ndev = plan.kl, plan.pr, plan.pc, grid.size
    a_b = plan.cap_a * plan.bm * plan.bk
    b_b = plan.cap_b * plan.bk * plan.bn
    if plan.engine == "cannon" and pr > 1:
        stats.record_comm("ppermute", 2 * pr * ndev, pr * ndev * (a_b + b_b) * itemsize)
    elif plan.engine == "gather":
        stats.record_comm("all_gather", 2 * ndev,
                          ndev * ((pc - 1) * a_b + (pr - 1) * b_b) * itemsize)
    if kl > 1:
        stats.record_comm("psum", (kl - 1) * pr * pc,
                          (kl - 1) * pr * pc * plan.cap_c * plan.bm * plan.bn * itemsize)


def _sparse_multiply_impl(alpha, matrix_a, matrix_b, beta, matrix_c, grid: Grid, name,
                          limits=(None,) * 6, retain_sparsity=False, filter_eps=None,
                          element_limits=None) -> BlockSparseMatrix:
    from dbcsr_tpu_torch.mm.multiply import (
        _apply_element_limits,
        _dense_mode_wanted,
        _real_scalar,
    )

    t_start = time.perf_counter()
    a, b, matrix_c, dtype, bm, bk, bn = _prepare_operands(matrix_a, matrix_b, matrix_c)
    alpha, beta = (_real_scalar(x, dtype) for x in (alpha, beta))
    shell = matrix_c if matrix_c is not None else BlockSparseMatrix(
        name or f"{a.name}*{b.name}", a.row_blk_sizes, b.col_blk_sizes, dtype,
        device=grid.home())
    beta_window = None
    if element_limits is not None:
        if any(x is not None for x in limits):
            raise ValueError("give block-index OR element limits, not both")
        a, b, limits, beta_window = _apply_element_limits(a, b, shell, element_limits)

    # the dense-mode gate shared with the single-device engine (ref the
    # generic driver's make_dense gate, `dbcsr_mm.F:593-617`): square
    # grids run high-fill products as the dense Cannon
    no_limits = all(x is None for x in limits)
    if grid.pr == grid.pc and _dense_mode_wanted(a, b, shell, filter_eps, retain_sparsity,
                                                 no_limits):
        return _dense_multiply_mesh(alpha, a, b, beta, matrix_c, grid, name, dtype)

    # plan lookup (pattern-keyed; filtered products depend on values
    # through the norm skip, so they plan every time)
    plan_key = None
    if filter_eps is None:
        plan_key = (
            a.pattern_fingerprint(), b.pattern_fingerprint(),
            matrix_c.pattern_fingerprint() if matrix_c is not None else None,
            a.dist.fingerprint(), b.dist.fingerprint(),
            matrix_c.dist.fingerprint() if matrix_c is not None else None,
            name_of(dtype), retain_sparsity, tuple(limits), beta_window, grid.key(),
            _config_token())
    plan = _plan_lookup(plan_key)
    hit = plan is not None
    t_plan = time.perf_counter()
    if plan is None:
        with timed("mesh_plan_build"):
            plan = _build_mesh_plan(a, b, matrix_c, grid, dtype, bm, bk, bn, limits,
                                    retain_sparsity, filter_eps, beta_window)
        _plan_insert(plan_key, plan)
        stats.record_comm("host2dev", 1, plan.index_bytes())
    t_plan = time.perf_counter() - t_plan

    home = grid.home()
    t0 = time.perf_counter()
    a_buf = _cached_panels(plan, "a", a, home)
    b_buf = _cached_panels(plan, "b", b, home)
    keep_old = beta != 0 or (plan.has_window and not plan.inside_all)
    c_init = beta_fac = None
    if plan.cinit_asm is not None and keep_old:
        c_init = _run_asm(plan.cinit_asm, matrix_c, dtype, home)
        beta_fac = _beta_factor(plan, beta, home)
    t_asm = time.perf_counter() - t0

    t0 = time.perf_counter()
    c_sum, mode = _run_engine(plan, grid, a_buf, b_buf, "mesh", site="mesh_shift")
    c_out = _finish(plan, c_sum, c_init, alpha, beta_fac)
    t_ticks = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = BlockSparseMatrix(
        name or (matrix_c.name if matrix_c is not None else f"{a.name}*{b.name}"),
        a.row_blk_sizes, b.col_blk_sizes, dtype, dist=plan.out_dist, device=home)
    _collect(plan, c_out, out)
    if filter_eps is not None and not retain_sparsity:
        # the final ||C|| >= eps pass, the single-device criterion
        from dbcsr_tpu_torch.ops.operations import filter_matrix

        filter_matrix(out, filter_eps)
    t_collect = time.perf_counter() - t0

    itemsize = dtype.itemsize
    stats.record_stack(bm, bn, bk, plan.n_cand, driver="mesh",
                       seconds=time.perf_counter() - t_start,
                       nbytes=_costmodel.stack_bytes(bm, bn, bk, plan.n_cand,
                                                     nseg=max(len(plan.c_keys), 1),
                                                     itemsize=itemsize),
                       dtype=name_of(dtype))
    stats.record_multiply(2 * out.nfullrows * out.nfullcols * a.nfullcols)
    stats.sample_memory()
    _record_traffic(plan, grid, itemsize)
    out._last_flops = plan.true_flops
    out._mm_algorithm = "stack"
    # what a caller can read of the run: host seconds per phase, the
    # plan-cache outcome, the overlap mode that ran, the padded flops the
    # stacks computed beside the true flops, and each tick's stacks
    out._mm_phase_s = {"plan": t_plan, "assemble": t_asm, "ticks": t_ticks,
                       "collect": t_collect}
    out._mm_plan_cache = "hit" if hit else ("miss" if plan_key is not None else None)
    out._mesh = {"engine": plan.engine, "grid": grid.label(), "mode": mode,
                 "nticks": plan.nticks, "padded_flops": 2 * bm * bk * bn * plan.n_cand,
                 "true_flops": plan.true_flops, "entries": plan.n_cand,
                 "caps": (plan.cap_a, plan.cap_b, plan.cap_c),
                 "stacks": {k: len(v[0]) for k, v in plan.stacks.items()},
                 "kernels": {k: p.kernel for k, p in plan.stack_plans.items() if p is not None},
                 # each stack's (entries, distinct A and B blocks, C runs):
                 # what its least time is computed from
                 "stack_sizes": {k: (p.entries, p.n_a, p.n_b, p.nruns)
                                 for k, p in plan.stack_plans.items() if p is not None}}
    return out


def _dense_multiply_mesh(alpha, a, b, beta, matrix_c, grid: Grid, name,
                         dtype) -> BlockSparseMatrix:
    """Grid dense mode: densify the operands on the device (the cached
    canvases), run the dense 2.5D Cannon over the same grid, and carve C
    back into its full block pattern (`dbcsr_make_dense` +
    `use_dense_mult`, `dbcsr_mm.F:593-617,770-810`).  The true sparse
    flops are returned; the dense work lands in the marketing counter."""
    from dbcsr_tpu_torch.core.dist import Distribution, ProcessGrid
    from dbcsr_tpu_torch.mm.multiply import (
        _dense_canvas_cached,
        _to_dense_device,
        _true_product_flops,
        carve_full_pattern,
    )
    from dbcsr_tpu_torch.parallel.cannon import cannon_multiply_dense

    t_start = time.perf_counter()
    s, kl = grid.pr, grid.kl
    home = grid.home()
    ad = _dense_canvas_cached(a).to(home, dtype)
    bd = _dense_canvas_cached(b).to(home, dtype)
    m_el, k_el = ad.shape
    n_el = bd.shape[1]
    mp, np_, kp = -(-m_el // s) * s, -(-n_el // s) * s, -(-k_el // (kl * s)) * (kl * s)
    if (mp, kp) != (m_el, k_el):
        ad = torch.nn.functional.pad(ad, (0, kp - k_el, 0, mp - m_el))
    if (kp, np_) != (k_el, n_el):
        bd = torch.nn.functional.pad(bd, (0, np_ - n_el, 0, kp - k_el))
    cd = cannon_multiply_dense(grid, ad, bd, acc_dtype=_acc_dtype(dtype))[:m_el, :n_el]
    cd = (alpha * cd).to(dtype)
    if beta != 0 and matrix_c is not None and matrix_c.nblks:
        cd = cd + beta * _to_dense_device(matrix_c).to(home, dtype)
    out_dist = (matrix_c.dist if matrix_c is not None and matrix_c.dist.grid.nprows == s
                and matrix_c.dist.grid.npcols == s
                else Distribution((np.arange(a.nblkrows) % s).astype(np.int32),
                                  (np.arange(b.nblkcols) % s).astype(np.int32),
                                  ProcessGrid(s, s, grid)))
    out = BlockSparseMatrix(
        name or (matrix_c.name if matrix_c is not None else f"{a.name}*{b.name}"),
        a.row_blk_sizes, b.col_blk_sizes, dtype, dist=out_dist, device=home)
    carve_full_pattern(out, cd.contiguous())
    bm = int(a.row_blk_sizes.max()) if a.nblkrows else 1
    bk = int(a.col_blk_sizes.max()) if a.nblkcols else 1
    bn = int(b.col_blk_sizes.max()) if b.nblkcols else 1
    itemsize = dtype.itemsize
    stats.record_stack(bm, bn, bk, a.nblkrows * b.nblkcols * a.nblkcols, driver="dense",
                       seconds=time.perf_counter() - t_start,
                       nbytes=_costmodel.dense_cost(out.nfullrows, out.nfullcols, a.nfullcols,
                                                    itemsize=itemsize)["bytes"],
                       dtype=name_of(dtype))
    stats.record_multiply(2 * out.nfullrows * out.nfullcols * a.nfullcols)
    stats.sample_memory()
    out._last_flops = _true_product_flops(a, b)
    out._mm_algorithm = "dense"
    return out


# --------------------------------------------------------- grouped TAS
def _balanced_groups(weights: np.ndarray, ngroups: int) -> np.ndarray:
    """Contiguous partition of a block axis into ngroups of about equal
    total weight (ref the long dimension split contiguously over process
    groups, `dbcsr_tas_split.F:66-304`)."""
    n = len(weights)
    if n == 0:
        return np.empty(0, np.int64)
    cum = np.cumsum(weights.astype(np.float64))
    total = cum[-1] if cum[-1] > 0 else 1.0
    frac = (cum - weights / 2) / total
    groups = np.minimum((frac * ngroups).astype(np.int64), ngroups - 1)
    return np.maximum.accumulate(groups)


def _build_grouped_plan(a, b, matrix_c, grid: Grid, dtype, bm, bk, bn, filter_eps,
                        nsplit) -> _MeshPlan:
    """The host half of a grouped TAS multiply: C's rows split into
    ``nsplit`` groups dealt over the 'kl' positions (q chunks each), one
    s x s Cannon per group, B replicated into every group."""
    from dbcsr_tpu_torch.mm.multiply import _candidates

    t0 = time.perf_counter()
    g, s = grid.kl, grid.pr
    home = grid.home()
    nbc_c = b.nblkcols
    rows_t, cols_t, a_ent, b_ent = _candidates(a, b, filter_eps)
    k_t = (a.keys % a.nblkcols).astype(np.int64)[a_ent]
    true_flops = _true_flops(a, b, rows_t, cols_t, k_t)

    ngroups = g if nsplit is None else max(int(nsplit), 1)
    ngroups = min(ngroups, max(a.nblkrows, 1))
    q = -(-ngroups // g)
    row_work = np.bincount(rows_t, minlength=a.nblkrows).astype(np.float64) + 1.0
    row_group = _balanced_groups(row_work, ngroups)
    row_kl, row_ch = row_group // q, row_group % q
    rdist_in = _panel_slots(row_group) % s  # rows round-robin within a group
    cdist = np.arange(b.nblkcols, dtype=np.int64) % s
    k_col = np.arange(a.nblkcols, dtype=np.int64) % s
    i_dev, j_dev, kc = rdist_in[rows_t], cdist[cols_t], k_col[k_t]
    tick_t = (kc - i_dev - j_dev) % s

    ar, ac = a.entry_coords()
    a_panel = (row_group[ar] * s + rdist_in[ar]) * s + k_col[ac]  # (group, i, kc)
    a_slots = _panel_slots(a_panel)
    cap_a = _cap(a_panel, ngroups * s * s)
    br, bc = b.entry_coords()
    b_panel = k_col[br] * s + cdist[bc]  # (kr, j), replicated over groups
    b_slots = _panel_slots(b_panel)
    cap_b = _cap(b_panel, s * s)

    old_keys = matrix_c.keys if matrix_c is not None else np.empty(0, np.int64)
    c_keys = np.union1d(old_keys, np.unique(rows_t * nbc_c + cols_t))
    c_rows = (c_keys // nbc_c).astype(np.int64)
    c_cols = (c_keys % nbc_c).astype(np.int64)
    c_panel = (row_group[c_rows] * s + rdist_in[c_rows]) * s + cdist[c_cols]
    c_slots = _panel_slots(c_panel)
    cap_c = _cap(c_panel, ngroups * s * s)
    ent_c = np.searchsorted(c_keys, rows_t * nbc_c + cols_t)

    nimg = g * s * s
    keep_img = np.array([grid.local(x) for x in range(nimg)])
    local_index = np.full(nimg, -1, np.int64)
    local_index[keep_img] = np.arange(int(keep_img.sum()))
    img_t = (row_kl[rows_t] * s + i_dev) * s + j_dev
    st_a = row_ch[ar][a_ent] * cap_a + a_slots[a_ent]
    st_c = row_ch[rows_t] * cap_c + c_slots[ent_c]
    stacks = _split_stacks(img_t * s + tick_t, st_a, b_slots[b_ent], st_c, nimg, s, keep_img)

    # panels start skewed; a group's chunk slots are offset by q
    agr, ai_, akc = a_panel // (s * s), (a_panel // s) % s, a_panel % s
    a_img = ((agr // q) * s + ai_) * s + (akc - ai_) % s
    a_asm = _make_asm(a, local_index[a_img] * (q * cap_a) + (agr % q) * cap_a + a_slots,
                      keep_img[a_img], int(keep_img.sum()) * q * cap_a, bm, bk, home)
    bkr, bj = b_panel // s, b_panel % s
    b_asm = _make_asm(b, (((bkr - bj) % s) * s + bj) * cap_b + b_slots,
                      np.ones(len(b_panel), bool), s * s * cap_b, bk, bn, home)
    c_flat = ((row_kl[c_rows] * s + rdist_in[c_rows]) * s + cdist[c_cols]) * (q * cap_c) \
        + row_ch[c_rows] * cap_c + c_slots
    cinit_asm = None
    if matrix_c is not None and matrix_c.nblks:
        pos_old = np.searchsorted(c_keys, old_keys)
        cinit_asm = _make_asm(matrix_c, c_flat[pos_old], np.ones(len(old_keys), bool),
                              nimg * q * cap_c, bm, bn, home)
    c_binning, collect = _collect_maps(a, b, c_rows, c_cols, c_flat, home)
    return _MeshPlan(
        engine="tas", kl=g, pr=s, pc=s, nticks=s, cap_a=q * cap_a, cap_b=cap_b,
        cap_c=q * cap_c, bm=bm, bk=bk, bn=bn, dtype=dtype, acc=_acc_dtype(dtype),
        true_flops=true_flops, n_cand=len(rows_t), stacks=stacks, a_asm=a_asm, b_asm=b_asm,
        cinit_asm=cinit_asm, has_window=False, inside_all=True, inside=None, c_keys=c_keys,
        c_binning=c_binning, collect=collect,
        out_dist=matrix_c.dist if matrix_c is not None else None, npanels_c=s * s,
        host_s=time.perf_counter() - t0,
        ngroups=int(row_group.max()) + 1 if len(row_group) else 0)


def tas_grouped_multiply(alpha, matrix_a: BlockSparseMatrix, matrix_b: BlockSparseMatrix,
                         beta, matrix_c: Optional[BlockSparseMatrix], mesh: Grid,
                         name: Optional[str] = None, filter_eps: Optional[float] = None,
                         nsplit: Optional[int] = None) -> BlockSparseMatrix:
    """Group-parallel tall-and-skinny multiply: C's (long) row dimension
    is split into ``nsplit`` groups (default: the grid's 'kl' size),
    each group runs its own s x s sparse Cannon, and the small matrix B
    is replicated into every group (ref `dbcsr_tas_multiply`'s grid
    split, `dbcsr_tas_mm.F:79-806`, `dbcsr_tas_split.F:304`).  Groups
    map onto the 'kl' positions, q = ceil(nsplit / kl) chunks each; row
    groups are disjoint, so the merge is a pure collect.  A column-long
    C is handled by the caller through transposition."""
    with _events.product_scope("tas_mesh_multiply",
                               name or f"{matrix_a.name}*{matrix_b.name}",
                               a=matrix_a.name, b=matrix_b.name):
        with timed("tas_grouped_cannon"):
            return _tas_grouped_impl(alpha, matrix_a, matrix_b, beta, matrix_c, mesh, name,
                                     filter_eps, nsplit)


def _tas_grouped_impl(alpha, matrix_a, matrix_b, beta, matrix_c, grid: Grid, name,
                      filter_eps, nsplit) -> BlockSparseMatrix:
    from dbcsr_tpu_torch.mm.multiply import _real_scalar

    t_start = time.perf_counter()
    if grid.pc != grid.pr:
        raise ValueError(
            "the grouped TAS path needs a square ('pr','pc') grid; rebuild the grid "
            "with make_grid/optimize_grid (square preferred automatically), or use "
            "sparse_multiply_distributed, whose all-gather engine supports "
            "rectangular grids")
    a, b, matrix_c, dtype, bm, bk, bn = _prepare_operands(matrix_a, matrix_b, matrix_c)
    alpha, beta = (_real_scalar(x, dtype) for x in (alpha, beta))
    plan_key = None
    if filter_eps is None:
        plan_key = ("tas", a.pattern_fingerprint(), b.pattern_fingerprint(),
                    matrix_c.pattern_fingerprint() if matrix_c is not None else None,
                    name_of(dtype), nsplit, grid.key(), _config_token())
    plan = _plan_lookup(plan_key)
    if plan is None:
        with timed("mesh_plan_build"):
            plan = _build_grouped_plan(a, b, matrix_c, grid, dtype, bm, bk, bn, filter_eps,
                                       nsplit)
        _plan_insert(plan_key, plan)
        stats.record_comm("host2dev", 1, plan.index_bytes())
    home = grid.home()
    a_buf = _cached_panels(plan, "a", a, home)
    b_buf = _cached_panels(plan, "b", b, home)
    c_init = beta_fac = None
    if plan.cinit_asm is not None and beta != 0:
        c_init = _run_asm(plan.cinit_asm, matrix_c, dtype, home)
        beta_fac = torch.tensor(beta, dtype=plan.acc, device=home).expand(grid.size,
                                                                          plan.cap_c)
    c_sum, _ = _run_engine(plan, grid, a_buf, b_buf, "tas", site="tas_tick")
    c_out = _finish(plan, c_sum, c_init, alpha, beta_fac)

    out = BlockSparseMatrix(
        name or (matrix_c.name if matrix_c is not None else f"{a.name}*{b.name}"),
        a.row_blk_sizes, b.col_blk_sizes, dtype,
        dist=matrix_c.dist if matrix_c is not None else None, device=home)
    _collect(plan, c_out, out)
    out._tas_ngroups = plan.ngroups
    if filter_eps is not None:
        from dbcsr_tpu_torch.ops.operations import filter_matrix

        filter_matrix(out, filter_eps)
    itemsize = dtype.itemsize
    stats.record_stack(bm, bn, bk, plan.n_cand, driver="mesh",
                       seconds=time.perf_counter() - t_start,
                       nbytes=_costmodel.stack_bytes(bm, bn, bk, plan.n_cand,
                                                     nseg=max(len(plan.c_keys), 1),
                                                     itemsize=itemsize),
                       dtype=name_of(dtype))
    stats.record_multiply(2 * out.nfullrows * out.nfullcols * a.nfullcols)
    stats.sample_memory()
    s = grid.pr
    if s > 1:
        # per-group panels: cap_a is the per-group maximum, cap_b the
        # replicated short matrix
        stats.record_comm("ppermute", 2 * s * grid.size,
                          s * grid.size * (plan.cap_a * bm * bk + plan.cap_b * bk * bn)
                          * itemsize)
    out._last_flops = plan.true_flops
    return out
