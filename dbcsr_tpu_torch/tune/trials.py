"""Bounded, watchdog-guarded tuning trials, off the hot path.

Counterpart of `dbcsr_tpu/tune/trials.py`.  A trial is one
non-persisting `acc.tune.tune_smm` sweep (on the card: K1, K3 at its
legal packs, K4 where the persisting-L2 window admits the operands, and
K1's demoted forms, each checked against its plain version) under three
guards:

* wall budget: ``DBCSR_TPU_TORCH_TUNE_BUDGET_S`` (120 s), checked after
  every timed candidate; the candidates already timed are the trial
  (``budget_hit``).  The ``tune_trial`` watchdog channel classifies the
  sweep (OK/SLOW/TRANSIENT/WEDGED);
* byte budget: the trial's stack size is clamped so its operands stay
  under ``DBCSR_TPU_TORCH_TUNE_BUDGET_BYTES`` (64 MiB), inside a
  `core.mempool.chain` scope;
* fault boundary: the ``tune_trial`` site (`resilience.sites`); an
  injected fault aborts the trial (``faulted``), and nothing is promoted
  from a trial that is not OK.

`run_format_trial` times the product of a mined format cell once per
forced format (stack, dense, composite) on a synthetic pair at the
cell's block shape and occupancy, the block grid clamped to 2-16 block
rows a dimension as in the JAX package: on the card such a product
measures launch and host cost more than the crossover.  Each leg's
clock stops after a `torch.cuda.synchronize` on the card.
`select_winner` skips every candidate whose (driver, shape) breaker is
open.  Trials run on ``device`` (the card unless the caller asks for
the CPU).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from dbcsr_tpu_torch.tune._env import env_float as _env_float
from dbcsr_tpu_torch.tune._env import env_int as _env_int

OK = "ok"
FAILED = "failed"
FAULTED = "faulted"
WEDGED = "wedged"

_MIN_TRIAL_STACK = 256


def budget_s() -> float:
    return max(1.0, _env_float("DBCSR_TPU_TORCH_TUNE_BUDGET_S", 120.0))


def budget_bytes() -> int:
    return max(1 << 20, _env_int("DBCSR_TPU_TORCH_TUNE_BUDGET_BYTES", 64 << 20))


def nrep() -> int:
    return max(1, _env_int("DBCSR_TPU_TORCH_TUNE_NREP", 2))


def clamp_stack_size(m: int, n: int, k: int, dtype,
                     want: int, budget: Optional[int] = None) -> int:
    """The largest trial stack size whose staged temporaries fit the
    byte budget.  Mirrors `acc.tune`'s allocation shape: A holds
    S/16 (m, k) blocks, B S/16 (k, n) blocks, C S/8 (m, n) segments,
    plus 12 B of int32 indices per entry."""
    from dbcsr_tpu_torch.core.kinds import dtype_of

    budget = budget_bytes() if budget is None else budget
    isz = dtype_of(dtype).itemsize
    per_entry = isz * (m * k / 16.0 + k * n / 16.0 + m * n / 8.0) + 12.0
    fit = int(budget / max(per_entry, 1.0))
    return max(_MIN_TRIAL_STACK, min(int(want), fit))


class _BudgetExhausted(Exception):
    """Internal: the wall budget elapsed — stop the sweep, keep the
    legs already measured."""


class _BudgetList(list):
    """Candidate sink that enforces the wall budget between legs: each
    append records the just-timed candidate, then aborts the sweep
    once the deadline passed (the current leg's timing is kept)."""

    def __init__(self, deadline_monotonic: float):
        super().__init__()
        self._deadline = deadline_monotonic

    def append(self, cand) -> None:
        super().append(cand)
        if time.monotonic() > self._deadline:
            raise _BudgetExhausted()


class TrialResult:
    """Outcome of one candidate sweep."""

    __slots__ = ("outcome", "cell", "entry", "candidates", "elapsed_s",
                 "error", "stack_size", "budget_hit")

    def __init__(self, outcome: str, cell: Dict, entry: Optional[Dict],
                 candidates: List[Dict], elapsed_s: float,
                 error: Optional[str], stack_size: int,
                 budget_hit: bool = False):
        self.outcome = outcome
        self.cell = cell
        self.entry = entry
        self.candidates = candidates
        self.elapsed_s = elapsed_s
        self.error = error
        self.stack_size = stack_size
        self.budget_hit = budget_hit

    @property
    def ok(self) -> bool:
        return self.outcome == OK

    def __repr__(self):
        return (f"TrialResult({self.outcome}, "
                f"cell={self.cell.get('m')}x{self.cell.get('n')}x"
                f"{self.cell.get('k')}:{self.cell.get('dtype')}, "
                f"candidates={len(self.candidates)}, "
                f"elapsed={self.elapsed_s:.2f}s)")


def _count_trial(outcome: str) -> None:
    try:
        from dbcsr_tpu_torch.obs import metrics

        metrics.counter(
            "dbcsr_tpu_tune_trials_total",
            "online-tuner trial sweeps by outcome (dbcsr_tpu_torch.tune)",
        ).inc(outcome=outcome)
    except Exception:
        pass


def run_trial(cell: Dict, seed: int = 7, out=None,
              deadline_s: Optional[float] = None,
              reps: Optional[int] = None, device=None) -> TrialResult:
    """Run one bounded candidate sweep for a mined cell.

    The cell dict carries ``m``/``n``/``k``/``dtype``/``stack_size``
    (the miner's schema).  Returns a `TrialResult`; ``entry`` is the
    raw sweep-best row (the SERVICE re-ranks candidates breaker-aware
    before promoting, see `select_winner`)."""
    from dbcsr_tpu_torch.core.kinds import enum_of
    from dbcsr_tpu_torch.resilience import faults
    from dbcsr_tpu_torch.resilience.watchdog import Watchdog

    m, n, k = int(cell["m"]), int(cell["n"]), int(cell["k"])
    dtype = cell.get("dtype", "float64")
    want = int(cell.get("stack_size", 30000))
    trial_s = clamp_stack_size(m, n, k, dtype, want)
    mnk = f"{m}x{n}x{k}"
    sink = out if out is not None else (lambda *a: None)
    wall_budget = budget_s() if deadline_s is None else deadline_s
    candidates: List[Dict] = _BudgetList(
        time.monotonic() + wall_budget)
    entry_box: list = [None]
    fault_abort = [False]
    budget_hit = [False]

    def _sweep(_deadline: float):
        # the injectable fault boundary: a raise/oom/fail here aborts
        # the trial before any timing ran; hang wedges the watchdog
        if faults.active():
            try:
                faults.maybe_inject("tune_trial", mnk=mnk,
                                    dtype=str(dtype))
            except BaseException:
                fault_abort[0] = True
                raise
        from dbcsr_tpu_torch.acc.tune import tune_smm

        def _run():
            entry_box[0] = tune_smm(
                m, n, k, dtype_enum=enum_of(dtype), stack_size=trial_s,
                nrep=nrep() if reps is None else reps, out=sink,
                seed=seed, persist=False, candidates_out=candidates,
                device=device)

        try:
            try:
                from dbcsr_tpu_torch.core import mempool

                # pool-chained temporaries: whatever the sweep stages
                # through the pool is chain-owned and donated back at
                # exit
                with mempool.chain():
                    _run()
            except ImportError:
                _run()
        except _BudgetExhausted:
            # the wall budget elapsed mid-sweep: the legs measured so
            # far ARE the trial (bounded by design, not an error)
            budget_hit[0] = True
        return entry_box[0]

    wd = Watchdog("tune_trial", deadline_s=wall_budget)
    res = wd.guard(_sweep)
    if res.outcome == "WEDGED":
        outcome = WEDGED
    elif res.error is not None:
        outcome = FAULTED if fault_abort[0] else FAILED
    else:
        outcome = OK
    _count_trial(outcome)
    try:
        from dbcsr_tpu_torch.obs import events as _events

        _events.publish("tune_trial", {
            "mnk": mnk, "dtype": str(dtype), "outcome": outcome,
            "stack_size": trial_s, "candidates": len(candidates),
            "budget_hit": budget_hit[0],
            "elapsed_s": round(res.elapsed_s, 3), "error": res.error,
        })
    except Exception:
        pass
    return TrialResult(outcome, cell, entry_box[0], list(candidates),
                       res.elapsed_s, res.error, trial_s,
                       budget_hit=budget_hit[0])


def run_format_trial(cell: Dict, seed: int = 7,
                     deadline_s: Optional[float] = None,
                     reps: Optional[int] = None, device=None) -> TrialResult:
    """A/B the storage formats for one mined format cell, OFF the hot
    path: build a synthetic product at the cell's (block shape, grid,
    occupancy), execute it once per forced format
    (``set_config(mm_format=…)`` — the same seam the planner's forced
    step reads), and return the fastest format as the trial entry.

    The entry carries FORMAT COLUMNS ONLY (``format``/``format_occ``/
    ``format_driver``/``format_gflops``): the service merges them into
    the incumbent kernel params row, never displacing the stack
    engine's driver fields.  Shares `run_trial`'s guard envelope: the
    ``tune_trial`` watchdog channel and fault site, the wall budget
    between format legs, the pool chain scope."""
    import numpy as np
    import torch

    from dbcsr_tpu_torch.resilience import faults
    from dbcsr_tpu_torch.resilience.watchdog import Watchdog

    m, n, k = int(cell["m"]), int(cell["n"]), int(cell["k"])
    dtype = cell.get("dtype", "float64")
    mnk = f"{m}x{n}x{k}"
    wall_budget = budget_s() if deadline_s is None else deadline_s
    # trial grids stay small: the crossover is a property of (occupancy,
    # block shape), not of the full production grid size
    grid = [max(2, min(int(g), 16)) for g in (cell.get("grid")
                                              or (8, 8, 8))]
    occ = min(max(float(cell.get("occ") or 0.9), 0.05), 1.0)
    rep_n = nrep() if reps is None else reps
    candidates: List[Dict] = []
    entry_box: list = [None]
    fault_abort = [False]
    budget_hit = [False]

    def _sweep(_deadline: float):
        if faults.active():
            try:
                faults.maybe_inject("tune_trial", mnk=mnk,
                                    dtype=str(dtype))
            except BaseException:
                fault_abort[0] = True
                raise
        from dbcsr_tpu_torch import create, make_random_matrix, multiply
        from dbcsr_tpu_torch.core.config import get_config, set_config
        from dbcsr_tpu_torch.mm import format_planner as fp

        nbr, nbc, nbk = grid
        rng = np.random.default_rng(seed)
        # the cell's occ is the PLANNER's unit: product-triple density
        # entries/(nbr*nbc*nbk).  Two random patterns at fill f meet in
        # ~f^2 of the triples, so build the synthetic pair at sqrt(occ)
        # to reproduce the mined product's density.
        fill = min(1.0, max(occ, 1e-4) ** 0.5)
        a = make_random_matrix("tune_fmt_a", [m] * nbr, [k] * nbk,
                               dtype=dtype, occupation=fill, rng=rng,
                               device=device)
        b = make_random_matrix("tune_fmt_b", [k] * nbk, [n] * nbc,
                               dtype=dtype, occupation=fill, rng=rng,
                               device=device)
        on_card = a.device.type == "cuda"
        deadline = time.monotonic() + wall_budget
        cfg0 = get_config()
        prev_fmt, prev_inc = cfg0.mm_format, cfg0.incremental
        try:
            from dbcsr_tpu_torch.core import mempool

            chain = mempool.chain
        except ImportError:
            import contextlib

            chain = contextlib.nullcontext
        try:
            # the delta-aware incremental plane would splice repeated
            # identical products and time the SPLICE, not the format
            set_config(incremental="full")
            with chain():
                for fmt in ("stack", "dense", "composite"):
                    set_config(mm_format=fmt)
                    fp.reset()  # forced plans must not reuse cached autos
                    best = None
                    executed = "stack"
                    for _ in range(max(rep_n, 1)):
                        c = create("tune_fmt_c", [m] * nbr, [n] * nbc,
                                   dtype=dtype, device=a.device)
                        if on_card:
                            torch.cuda.synchronize(a.device)
                        t0 = time.perf_counter()
                        multiply("N", "N", 1.0, a, b, 0.0, c)
                        if on_card:
                            torch.cuda.synchronize(a.device)
                        dt = time.perf_counter() - t0
                        executed = getattr(c, "_mm_algorithm", "stack")
                        best = dt if best is None or dt < best else best
                    if executed == fmt and best and best > 0:
                        flops = 2.0 * (nbr * m) * (nbc * n) * (nbk * k)
                        candidates.append({
                            "format": fmt,
                            "seconds": round(best, 6),
                            "gflops": round(flops / best / 1e9, 4),
                        })
                    # an infeasible force fell back: not a candidate
                    if time.monotonic() > deadline:
                        budget_hit[0] = True
                        break
        finally:
            set_config(mm_format=prev_fmt, incremental=prev_inc)
            fp.reset()
        if candidates:
            win = max(candidates, key=lambda c_: c_["gflops"])
            entry = {
                "m": m, "n": n, "k": k, "dtype": str(dtype),
                "format": win["format"],
                # the crossover: at or above the occupancy the win was
                # measured at, use the winning format (a stack win pins
                # stack everywhere — occ 0.0 always applies)
                "format_occ": (0.0 if win["format"] == "stack"
                               else round(occ, 4)),
                "format_gflops": win["gflops"],
            }
            if win["format"] in ("dense", "composite"):
                entry["format_driver"] = win["format"]
            entry_box[0] = entry
        return entry_box[0]

    wd = Watchdog("tune_trial", deadline_s=wall_budget)
    res = wd.guard(_sweep)
    if res.outcome == "WEDGED":
        outcome = WEDGED
    elif res.error is not None:
        outcome = FAULTED if fault_abort[0] else FAILED
    else:
        outcome = OK
    _count_trial(outcome)
    try:
        from dbcsr_tpu_torch.obs import events as _events

        _events.publish("tune_trial", {
            "mnk": mnk, "dtype": str(dtype), "outcome": outcome,
            "axis": "format", "candidates": len(candidates),
            "budget_hit": budget_hit[0],
            "elapsed_s": round(res.elapsed_s, 3), "error": res.error,
        })
    except Exception:
        pass
    return TrialResult(outcome, cell, entry_box[0], list(candidates),
                       res.elapsed_s, res.error,
                       int(cell.get("stack_size", 0)),
                       budget_hit=budget_hit[0])


def _breaker_open(driver: str, m: int, n: int, k: int, dtype) -> bool:
    """Whether the live breaker board holds an OPEN breaker for this
    (driver, shape).  Never CREATES a board; shape matching is by the
    board's ``driver|MxNxKx<dtype>`` snapshot spelling (the same key
    `acc.smm` registers launches under)."""
    import sys

    from dbcsr_tpu_torch.core.kinds import name_of

    br = sys.modules.get("dbcsr_tpu_torch.resilience.breaker")
    board = getattr(br, "_board", None) if br is not None else None
    if board is None:
        return False
    want = f"{m}x{n}x{k}x{name_of(dtype)}"
    for key, ent in board.snapshot().items():
        drv, _, shape = key.partition("|")
        if drv == driver and ent["state"] == "open" \
                and shape.startswith(want):
            return True
    return False


def select_winner(candidates: List[Dict], m: int, n: int, k: int,
                  dtype) -> Optional[Dict]:
    """The fastest candidate whose (driver, shape) breaker is not
    open.  Returns None when every candidate is quarantined (the
    service then promotes nothing)."""
    best = None
    for cand in candidates:
        driver = cand.get("driver")
        if driver and _breaker_open(driver, m, n, k, dtype):
            continue
        if best is None or cand.get("gflops", 0) > best.get("gflops", 0):
            best = cand
    return best
