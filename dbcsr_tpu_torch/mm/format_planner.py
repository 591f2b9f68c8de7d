"""The storage-format planner: stack, dense or composite, per product.

Counterpart of `dbcsr_tpu/mm/format_planner.py`.  Three executions of
the identical product (`mm/multiply.py`): ``stack`` (the BCSR stack
engine), ``dense`` (one GEMM over padded canvases, chunked beyond the
canvas cap) and ``composite`` (row panels with narrow k-support in one
batched GEMM).  The decision funnel, first hit wins:

0. the ``format_plan`` fault site: an injected fault degrades the plan
   to stack for this product only (``reason="fault"``, never cached);
1. a product only the stack format can run (filtered, limited,
   ``retain_sparsity``, a symmetric C, ``mm_dense=False`` or the forced
   base kernel ``mm_driver="pallas"``): stack, ``reason="structural"``;
2. ``mm_format`` forced: that format (``"forced"``), or stack when the
   product cannot take it (``"ineligible"``: composite without panels);
3. a tuned row of the block cell (`acc/params.py:lookup`) with
   ``format``/``format_occ`` columns, or else the nearest row that has
   them (`tune.predictor.format_prior`): its format at or above its
   occupancy crossover, else stack (``"tuned"``);
4. the dense heuristic (`mm.multiply._dense_mode_wanted`): dense
   (``"heuristic"``);
5. stack (``"default"`` for a uniform blocking, else ``"structural"``).

Decisions are cached by the operands' and C's pattern fingerprints, C's
dtype, the config fields the funnel reads and the tuned table's path
and generation.  `mm.multiply.read_totals` counts them by (format,
reason).  A uniform product's plan carries the modeled cost of each
format (`obs.costmodel.format_costs`, on the device's peak row).

Observability (ref `dbcsr_tpu/mm/format_planner.py:271-373`): every
decision is counted (``dbcsr_tpu_format_decision_total{format,reason}``),
noted on the flight record and the multiply's span (`note_decision`),
and a changed choice for a cell is published as a ``format_decision``
event; every executed canvas product reports its measured rate against
the model's (`note_outcome`) into a bounded regret ring
(`regret_records`, `regret_gauges`, `mis_crossovers`), which the online
tuner mines (`tune.miner.mine_format`).  The JAX package's MXU cost
curves (step 5 there) have no counterpart here.
"""

from __future__ import annotations

import collections
import threading
import time
from collections import OrderedDict
from typing import Optional

from dbcsr_tpu_torch.acc import params
from dbcsr_tpu_torch.core.config import get_config
from dbcsr_tpu_torch.core.kinds import name_of
from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY
from dbcsr_tpu_torch.obs import costmodel, events, flight, metrics, tracer
from dbcsr_tpu_torch.resilience import faults

FORMATS = ("stack", "dense", "composite")

_PLAN_CACHE_MAX = 256
_plan_cache: OrderedDict = OrderedDict()
_lock = threading.Lock()
_regret: collections.deque = collections.deque(maxlen=256)
# a measured/predicted ratio below this marks a decision as a regret
_REGRET_FLOOR = 0.5
# the last (format, reason) per cell: a changed choice is published
_last_choice: dict = {}


class Plan:
    """One product's format decision and what it rode on: the reason,
    the composite panels (of a composite plan), the block cell (bm, bn,
    bk, dtype), the pair occupancy (block products over nbr*nbc*nbk) and
    the block grid (nbr, nbc, nbk) and, for a uniform product, the
    modeled cost of each format (``predicted``, `costmodel.format_costs`)."""

    __slots__ = ("fmt", "reason", "panels", "predicted", "cell", "occ", "grid")

    def __init__(self, fmt: str, reason: str, panels=None, predicted: Optional[dict] = None,
                 cell: Optional[tuple] = None, occ: Optional[float] = None,
                 grid: Optional[tuple] = None):
        self.fmt = fmt
        self.reason = reason
        self.panels = panels
        self.predicted = predicted
        self.cell = cell
        self.occ = occ
        self.grid = grid

    def __repr__(self):
        return f"Plan({self.fmt}, reason={self.reason}, occ={self.occ})"


def reset() -> None:
    """Drop the cached decisions, the regret ring and the last choices."""
    with _lock:
        _plan_cache.clear()
        _regret.clear()
        _last_choice.clear()


def _tuned_row(bm: int, bn: int, bk: int, dtype: str) -> Optional[dict]:
    """The tuned row of this block cell if it carries a format, else the
    nearest same-device-kind row that carries one
    (`tune.predictor.format_prior`, the donor), else None."""
    row = params.lookup(bm, bn, bk, dtype)
    if row and row.get("format") in FORMATS:
        return row
    from dbcsr_tpu_torch.tune.predictor import format_prior

    row = format_prior(bm, bn, bk, dtype)
    return row if row and row.get("format") in FORMATS else None


def choose(a, b, c, *, filter_eps, retain_sparsity, no_limits) -> Plan:
    """The product's execution format (see the module's funnel)."""
    cfg = get_config()
    if not (filter_eps is None and not retain_sparsity and no_limits
            and c.matrix_type == NO_SYMMETRY
            and cfg.mm_dense is not False and cfg.mm_driver != "pallas"):
        return Plan("stack", "structural")
    if faults.active():
        try:
            faults.maybe_inject("format_plan", name=c.name)
        except Exception:  # noqa: BLE001 -- an injected fault degrades this plan only
            return Plan("stack", "fault")
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
    entries = 0
    if uniform:
        bm, bn, bk = int(c.row_blk_sizes[0]), int(c.col_blk_sizes[0]), int(a.col_blk_sizes[0])
        nbr, nbc, nbk = a.nblkrows, c.nblkcols, a.nblkcols
        cell = (bm, bn, bk, name_of(c.dtype))
        grid = (nbr, nbc, nbk)
        entries = max(int(round(mm._true_product_flops(a, b) / (2.0 * bm * bn * bk))), 0)
        occ = entries / float(max(nbr * nbc * nbk, 1))

    def plan(fmt, reason):
        panels = mm.composite_panels(a, b, c) if fmt == "composite" else None
        predicted = None
        if cell is not None:
            predicted = costmodel.format_costs(
                nbr=grid[0], nbc=grid[1], nbk=grid[2], bm=cell[0], bn=cell[1], bk=cell[2],
                entries=entries, panels=(panels.G, panels.mp, panels.kp) if panels else None,
                dtype=cell[3], itemsize=c.dtype.itemsize)
        return Plan(fmt, reason, panels=panels, predicted=predicted, cell=cell, occ=occ,
                    grid=grid)

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


# ------------------------------------------------------------ observability
def note_decision(plan: Plan) -> None:
    """Count one decision and note it on the flight record and the
    multiply's span (once per multiply: cached decisions count too)."""
    metrics.counter("dbcsr_tpu_format_decision_total",
                    "storage-format planner decisions by chosen format and reason "
                    "(mm.format_planner)").inc(format=plan.fmt, reason=plan.reason)
    flight.note("format", plan.fmt)
    flight.note("format_reason", plan.reason)
    if plan.occ is not None:
        flight.note("format_occ", round(plan.occ, 4))
    tracer.annotate(format=plan.fmt, format_reason=plan.reason)
    _note_choice_change(plan)


def _note_choice_change(plan: Plan) -> None:
    """Publish a ``format_decision`` event when a cell's (format, reason)
    changed; the first sighting of a cell is its baseline."""
    key = str(plan.cell) if plan.cell is not None else "uncelled"
    choice = (plan.fmt, plan.reason)
    with _lock:
        prev = _last_choice.get(key)
        _last_choice[key] = choice
    if prev is None or prev == choice:
        return
    events.publish("format_decision", {"cell": key, "format": plan.fmt, "reason": plan.reason,
                                       "prev": f"{prev[0]}:{prev[1]}"})


def note_outcome(plan: Plan, seconds: float, flops: float) -> None:
    """Record one executed product's measured rate against the model's
    prediction for the chosen format (the regret ring)."""
    if plan.predicted is None or plan.cell is None or seconds <= 0:
        return
    leg = plan.predicted.get(plan.fmt)
    if not leg or not leg.get("gflops"):
        return
    measured = flops / seconds / 1e9
    predicted = float(leg["gflops"])
    rec = {
        "format": plan.fmt,
        "reason": plan.reason,
        "cell": plan.cell,
        "grid": plan.grid,
        "occ": plan.occ,
        "predicted_gflops": round(predicted, 4),
        "measured_gflops": round(measured, 4),
        "ratio": round(measured / predicted, 6) if predicted else 0.0,
        "predicted_alternatives": {f: round(v["gflops"], 4)
                                   for f, v in plan.predicted.items() if v},
        "t_unix": time.time(),
    }
    with _lock:
        _regret.append(rec)


def regret_records(limit: Optional[int] = None) -> list:
    """The recent outcome records, oldest first."""
    with _lock:
        recs = list(_regret)
    return recs if limit is None else recs[-limit:]


def regret_gauges() -> list:
    """The latest measured/predicted ratio per format, as ``(labels,
    value)`` points (``dbcsr_tpu_format_regret``)."""
    latest: dict = {}
    with _lock:
        for rec in _regret:
            latest[rec["format"]] = rec["ratio"]
    return [({"format": f}, r) for f, r in sorted(latest.items())]


def mis_crossovers(floor: float = _REGRET_FLOOR) -> list:
    """The cells whose chosen format fell below ``floor`` of its model's
    rate on their latest sighting."""
    latest: dict = {}
    with _lock:
        for rec in _regret:
            latest[(rec["cell"], rec["format"])] = rec
    return [r for r in latest.values() if r["ratio"] < floor]
