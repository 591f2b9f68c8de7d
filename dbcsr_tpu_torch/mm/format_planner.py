"""The storage-format planner: stack, dense or composite, per product.

Counterpart of `dbcsr_tpu/mm/format_planner.py`.  Three executions of
the identical product (`mm/multiply.py`): ``stack`` (the BCSR stack
engine), ``dense`` (one GEMM over padded canvases, chunked beyond the
canvas cap) and ``composite`` (row panels with narrow k-support in one
batched GEMM).  The decision funnel, first hit wins:

1. a product only the stack format can run (filtered, limited,
   ``retain_sparsity``, a symmetric C, ``mm_dense=False`` or the forced
   base kernel ``mm_driver="pallas"``): stack, ``reason="structural"``;
2. ``mm_format`` forced: that format (``"forced"``), or stack when the
   product cannot take it (``"ineligible"``: composite without panels);
3. a tuned row of the block cell (`acc/params.py:lookup`) with
   ``format``/``format_occ`` columns: its format at or above its
   occupancy crossover, else stack (``"tuned"``);
4. the dense heuristic (`mm.multiply._dense_mode_wanted`): dense
   (``"heuristic"``);
5. stack (``"default"`` for a uniform blocking, else ``"structural"``).

Decisions are cached by the operands' and C's pattern fingerprints, C's
dtype, the config fields the funnel reads and the tuned table's path
and generation.  `mm.multiply.read_totals` counts them by (format,
reason).  The JAX package's MXU cost curves (step 5 there), its donor
row (`tune.predictor.format_prior`), its ``format_plan`` fault site and
its regret ring (`note_outcome`) have no counterpart here.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from dbcsr_tpu_torch.acc import params
from dbcsr_tpu_torch.core.config import get_config
from dbcsr_tpu_torch.core.kinds import name_of
from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY

FORMATS = ("stack", "dense", "composite")

_PLAN_CACHE_MAX = 256
_plan_cache: OrderedDict = OrderedDict()


class Plan:
    """One product's format decision and what it rode on: the reason,
    the composite panels (of a composite plan), the block cell (bm, bn,
    bk, dtype), the pair occupancy (block products over nbr*nbc*nbk) and
    the block grid (nbr, nbc, nbk)."""

    __slots__ = ("fmt", "reason", "panels", "cell", "occ", "grid")

    def __init__(self, fmt: str, reason: str, panels=None, cell: Optional[tuple] = None,
                 occ: Optional[float] = None, grid: Optional[tuple] = None):
        self.fmt = fmt
        self.reason = reason
        self.panels = panels
        self.cell = cell
        self.occ = occ
        self.grid = grid

    def __repr__(self):
        return f"Plan({self.fmt}, reason={self.reason}, occ={self.occ})"


def reset() -> None:
    """Drop the cached decisions."""
    _plan_cache.clear()


def _tuned_row(bm: int, bn: int, bk: int, dtype: str) -> Optional[dict]:
    """The tuned row of this block cell if it carries a format."""
    row = params.lookup(bm, bn, bk, dtype)
    return row if row and row.get("format") in FORMATS else None


def choose(a, b, c, *, filter_eps, retain_sparsity, no_limits) -> Plan:
    """The product's execution format (see the module's funnel)."""
    cfg = get_config()
    if not (filter_eps is None and not retain_sparsity and no_limits
            and c.matrix_type == NO_SYMMETRY
            and cfg.mm_dense is not False and cfg.mm_driver != "pallas"):
        return Plan("stack", "structural")
    key = (a.pattern_fingerprint(), b.pattern_fingerprint(), c.pattern_fingerprint(),
           name_of(c.dtype),
           (cfg.mm_format, cfg.mm_dense, cfg.mm_driver, cfg.dense_occ_threshold,
            cfg.composite_max_panels, cfg.composite_ksup),
           params.params_path(), params.generation())
    plan = _plan_cache.get(key)
    if plan is not None:
        _plan_cache.move_to_end(key)
        return plan
    plan = _choose_uncached(a, b, c, cfg)
    _plan_cache[key] = plan
    while len(_plan_cache) > _PLAN_CACHE_MAX:
        _plan_cache.popitem(last=False)
    return plan


def _choose_uncached(a, b, c, cfg) -> Plan:
    from dbcsr_tpu_torch.mm import multiply as mm

    uniform = mm._uniform(a) and mm._uniform(b) and mm._uniform(c)
    cell = occ = grid = None
    if uniform:
        bm, bn, bk = int(c.row_blk_sizes[0]), int(c.col_blk_sizes[0]), int(a.col_blk_sizes[0])
        nbr, nbc, nbk = a.nblkrows, c.nblkcols, a.nblkcols
        cell = (bm, bn, bk, name_of(c.dtype))
        grid = (nbr, nbc, nbk)
        entries = max(int(round(mm._true_product_flops(a, b) / (2.0 * bm * bn * bk))), 0)
        occ = entries / float(max(nbr * nbc * nbk, 1))

    def plan(fmt, reason):
        panels = mm.composite_panels(a, b, c) if fmt == "composite" else None
        return Plan(fmt, reason, panels=panels, cell=cell, occ=occ, grid=grid)

    def feasible(fmt):
        # the panels are planned only when composite is asked for
        return fmt != "composite" or mm.composite_panels(a, b, c) is not None

    if cfg.mm_format != "auto":
        return plan(cfg.mm_format, "forced") if feasible(cfg.mm_format) \
            else plan("stack", "ineligible")
    if cell is not None:
        row = _tuned_row(*cell)
        if row is not None:
            fmt = str(row["format"])
            if occ >= float(row.get("format_occ", 0.0)) and feasible(fmt):
                return plan(fmt, "tuned")
            return plan("stack", "tuned")
    if mm._dense_mode_wanted(a, b, c, None, False, True):
        return plan("dense", "heuristic")
    return plan("stack", "default" if uniform else "structural")
