"""The online tuner's loop: mine, trial, promote.

Counterpart of `dbcsr_tpu/tune/service.py`.  One `cycle()` is the
closed loop, synchronous (the background thread only paces cycles on
``DBCSR_TPU_TORCH_TUNE_INTERVAL_S``):

1. admission gate: the cycle runs only while
   `obs.health.admission_status()` is OK;
2. regression judge: `store.check_regressions()` demotes a promoted
   row whose live roofline cell collapsed;
3. `store.peer_sync()` adopts same-device-kind peers' promotions;
4. mine: `miner.mine()`; the top cell gets the cycle's trial;
5. trial: `trials.run_trial()`; a trial that is not OK promotes nothing;
6. promote: the breaker-aware winner (`trials.select_winner`) through
   `store.promote`, when it beats the cell's observed rate by
   ``DBCSR_TPU_TORCH_TUNE_MARGIN`` (5%) and differs from the incumbent
   row.  The params generation bump retires every cached plan.

A cycle with an empty kernel queue spends itself on the format axis:
`miner.mine_format`, `trials.run_format_trial`, and the winning format
columns merged into the incumbent row.  ``DBCSR_TPU_TORCH_TUNE=1``
starts the background thread (`maybe_start_from_env`);
`current_service()` is the obs layers' read seam (the ``tune`` health
component, the telemetry collector) and never creates a service.
Trials run on ``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from dbcsr_tpu_torch.tune import miner, store, trials
from dbcsr_tpu_torch.tune._env import env_float as _env_float

_lock = threading.Lock()
_service: Optional["TuneService"] = None


class TuneService:
    """The online tuner: one instance per process (module singleton via
    `get_service`), cycles run synchronously or on the background
    thread."""

    def __init__(self, interval_s: Optional[float] = None,
                 kind: Optional[str] = None, seed: int = 7, device=None):
        self.interval_s = (_env_float("DBCSR_TPU_TORCH_TUNE_INTERVAL_S", 60.0)
                           if interval_s is None else float(interval_s))
        self.margin = _env_float("DBCSR_TPU_TORCH_TUNE_MARGIN", 0.05)
        self.kind = kind
        self.seed = seed
        self.device = device
        # the last trial's `trials.TrialResult` (its candidates), for callers
        # that report a cycle
        self.last_trial = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._state_lock = threading.Lock()
        self.stats: Dict = {
            "cycles": 0, "trials": 0, "promotions": 0, "demotions": 0,
            "deferred": 0, "queue_depth": 0, "last_cycle_s": 0.0,
            "last_outcome": None, "last_error": None,
            "last_cycle_demoted": False,
            "trial_failure_streak": 0,
        }

    # ------------------------------------------------------------ state

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def snapshot(self) -> Dict:
        with self._state_lock:
            snap = dict(self.stats)
        snap["running"] = self.running
        snap["interval_s"] = self.interval_s
        snap["generation"] = store.generation()
        return snap

    def _note(self, **updates) -> None:
        with self._state_lock:
            self.stats.update(updates)

    # ------------------------------------------------------------ cycle

    def cycle(self, cells: Optional[List[Dict]] = None) -> Dict:
        """One mine → trial → promote pass.  Returns the outcome dict
        (also folded into `snapshot()`)."""
        t0 = time.monotonic()
        with self._state_lock:
            self.stats["cycles"] += 1
        out: Dict = {"outcome": "idle", "cell": None, "promoted": None,
                     "demoted": []}
        try:
            out = self._cycle_inner(cells, out)
            self._note(last_error=None)
        except Exception as exc:
            out["outcome"] = "error"
            out["error"] = f"{type(exc).__name__}: {exc}"
            self._note(last_error=out["error"])
        dur = time.monotonic() - t0
        # demotion visibility is its OWN flag: a cycle that demotes a
        # regressed row and then also promotes/fails its trial would
        # otherwise overwrite last_outcome and hide the demotion from
        # the health component's operator page
        self._note(last_cycle_s=round(dur, 4),
                   last_outcome=out["outcome"],
                   last_cycle_demoted=bool(out.get("demoted")))
        try:
            from dbcsr_tpu_torch.obs import metrics

            metrics.gauge(
                "dbcsr_tpu_tune_cycle_seconds",
                "wall seconds of the last online-tuner cycle",
            ).set(round(dur, 4))
        except Exception:
            pass
        return out

    def _admission(self) -> str:
        try:
            from dbcsr_tpu_torch.obs import health

            return health.admission_status()
        except Exception:
            return "OK"

    def _cycle_inner(self, cells, out: Dict) -> Dict:
        admission = self._admission()
        if admission != "OK":
            # a degraded process tunes nothing: trials compete with the
            # traffic that degraded it (serve admission shares this
            # verdict, so the gate can never starve a healthy worker)
            with self._state_lock:
                self.stats["deferred"] += 1
            out["outcome"] = f"deferred:{admission}"
            return out
        demoted = store.check_regressions(kind=self.kind)
        if demoted:
            with self._state_lock:
                self.stats["demotions"] += len(demoted)
            out["demoted"] = demoted
            out["outcome"] = "demoted"
        try:
            # fleet tier: adopt same-device-kind peers' promotions so
            # one worker's trial pays for the whole fleet (bounded
            # per-peer timeout + cool-off inside peer_sync; a peerless
            # process returns [] without any I/O)
            adopted = store.peer_sync(kind=self.kind)
        except Exception:
            adopted = []
        if adopted:
            with self._state_lock:
                self.stats["adoptions"] = \
                    self.stats.get("adoptions", 0) + len(adopted)
            out["adopted"] = adopted
        if cells is None:
            cells = miner.mine()
        self._note(queue_depth=len(cells))
        if not cells:
            # no kernel cell wastes FLOP-seconds: spend the idle cycle
            # on the FORMAT axis (planner regrets mined off the live
            # mis-crossover ring; same trial guards, merge-promotion)
            return self._format_cycle(out)
        cell = cells[0]
        out["cell"] = {k: cell.get(k)
                       for k in ("m", "n", "k", "dtype", "stack_size",
                                 "wasted_flop_seconds", "reason")}
        with self._state_lock:
            self.stats["trials"] += 1
        trial = self.last_trial = trials.run_trial(cell, seed=self.seed, device=self.device)
        if not trial.ok:
            with self._state_lock:
                self.stats["trial_failure_streak"] += 1
            out["outcome"] = f"trial_{trial.outcome}"
            out["error"] = trial.error
            return out
        self._note(trial_failure_streak=0)
        winner = trials.select_winner(trial.candidates, int(cell["m"]),
                                      int(cell["n"]), int(cell["k"]),
                                      cell.get("dtype", "float64"))
        if winner is None:
            out["outcome"] = "quarantined"
            return out
        promoted = self._maybe_promote(cell, trial, winner)
        if promoted is not None:
            with self._state_lock:
                self.stats["promotions"] += 1
            out["promoted"] = {
                "driver": promoted["entry"].get("driver"),
                "gflops": promoted["entry"].get("gflops"),
                "generation": promoted["generation"],
            }
            out["outcome"] = "promoted"
        elif out["outcome"] != "demoted":
            out["outcome"] = "held"
        return out

    def _incumbent_gflops(self, cell: Dict) -> Optional[float]:
        """The evidence bar a winner must clear: what the cell
        ACHIEVES live (the miner's observed rate).  Deliberately NOT
        the incumbent row's gflops claim — a stale row whose number
        was measured in another life (another device or run)
        must not be able to block its own displacement.  The claim is
        the fallback only when the cell was mined without a live
        rate."""
        obs = cell.get("observed_gflops")
        if isinstance(obs, (int, float)) and obs > 0:
            return float(obs)
        try:
            from dbcsr_tpu_torch.acc import params as params_mod

            row = params_mod.predict(
                int(cell["m"]), int(cell["n"]), int(cell["k"]),
                cell.get("dtype", "float64"),
                stack_size=cell.get("stack_size"))
        except Exception:
            row = None
        claim = (row or {}).get("gflops")
        return float(claim) if isinstance(claim, (int, float)) \
            and claim > 0 else None

    @staticmethod
    def _same_config(winner: Dict, incumbent: Optional[Dict]) -> bool:
        if not incumbent:
            return False
        fields = ("driver", "grouping", "r0", "variant", "pack_p",
                  "precision")
        return all(winner.get(f) == incumbent.get(f) for f in fields)

    def _maybe_promote(self, cell: Dict, trial, winner: Dict):
        from dbcsr_tpu_torch.acc import params as params_mod
        from dbcsr_tpu_torch.core.kinds import name_of

        m, n, k = int(cell["m"]), int(cell["n"]), int(cell["k"])
        dtype = name_of(cell.get("dtype", "float64"))
        incumbent = params_mod.lookup(m, n, k, dtype,
                                      stack_size=cell.get("stack_size"))
        if self._same_config(winner, incumbent):
            return None  # the table already says this; don't churn plans
        bar = self._incumbent_gflops(cell)
        if bar is not None and winner.get("gflops", 0.0) \
                <= bar * (1.0 + self.margin):
            return None
        base = trial.entry or {}
        row = {
            "m": m, "n": n, "k": k, "dtype": dtype,
            "stack_size": trial.stack_size,
            "env": base.get("env", "cpu"),
            **{f: winner[f] for f in winner
               if f not in ("m", "n", "k", "dtype", "stack_size", "env")},
        }
        row["gflops"] = round(float(winner.get("gflops", 0.0)), 2)
        return store.promote(
            row,
            trial={"stack_size": trial.stack_size,
                   "elapsed_s": round(trial.elapsed_s, 3),
                   "candidates": trial.candidates,
                   "mined": {kk: cell.get(kk) for kk in
                             ("observed_gflops", "target_gflops",
                              "wasted_flop_seconds", "reason",
                              "source")}},
            stack_size=int(cell.get("stack_size", trial.stack_size)),
            kind=self.kind)

    def _format_cycle(self, out: Dict) -> Dict:
        """Idle-cycle format-axis pass: trial the worst planner
        mis-crossover and merge the winning format columns into the
        incumbent params row.  A non-OK trial promotes nothing."""
        cells = miner.mine_format()
        if not cells:
            return out
        cell = cells[0]
        out["cell"] = {k: cell.get(k)
                       for k in ("m", "n", "k", "dtype", "format", "occ",
                                 "wasted_flop_seconds", "reason")}
        with self._state_lock:
            self.stats["trials"] += 1
        trial = self.last_trial = trials.run_format_trial(cell, seed=self.seed,
                                                          device=self.device)
        if not trial.ok:
            with self._state_lock:
                self.stats["trial_failure_streak"] += 1
            out["outcome"] = f"trial_{trial.outcome}"
            out["error"] = trial.error
            return out
        self._note(trial_failure_streak=0)
        promoted = self._maybe_promote_format(cell, trial)
        if promoted is not None:
            with self._state_lock:
                self.stats["promotions"] += 1
            out["promoted"] = {
                "format": promoted["entry"].get("format"),
                "format_occ": promoted["entry"].get("format_occ"),
                "generation": promoted["generation"],
            }
            out["outcome"] = "promoted"
        elif out["outcome"] != "demoted":
            out["outcome"] = "held"
        return out

    def _maybe_promote_format(self, cell: Dict, trial):
        """Merge the trial's format columns into the incumbent kernel
        row (or start a fresh row when none exists) — the kernel
        engine's driver/grouping fields are never displaced.  The bar:
        the winning format must beat the planner's measured rate for
        the cell by the promotion margin, and re-pinning the format
        the planner already chose is churn, not progress."""
        from dbcsr_tpu_torch.core.kinds import name_of

        entry = trial.entry
        if not entry or not entry.get("format"):
            return None
        if entry["format"] == cell.get("format"):
            return None  # the trial agreed with the regretted plan
        bar = cell.get("observed_gflops")
        if isinstance(bar, (int, float)) and bar > 0 and \
                entry.get("format_gflops", 0.0) <= bar * (1.0 + self.margin):
            return None
        from dbcsr_tpu_torch.acc import params as params_mod

        m, n, k = int(cell["m"]), int(cell["n"]), int(cell["k"])
        dtype = name_of(cell.get("dtype", "float64"))
        incumbent = params_mod.lookup(
            m, n, k, dtype, stack_size=cell.get("stack_size")) or {}
        row = dict(incumbent)
        row.update({
            "m": m, "n": n, "k": k, "dtype": dtype,
            "stack_size": int(cell.get("stack_size")
                              or incumbent.get("stack_size") or 0),
            "env": incumbent.get("env", "cpu"),
            "format": entry["format"],
            "format_occ": entry["format_occ"],
            "format_gflops": entry["format_gflops"],
        })
        if entry.get("format_driver"):
            row["format_driver"] = entry["format_driver"]
        else:
            row.pop("format_driver", None)
        return store.promote(
            row,
            trial={"axis": "format",
                   "elapsed_s": round(trial.elapsed_s, 3),
                   "candidates": trial.candidates,
                   "mined": {kk: cell.get(kk) for kk in
                             ("format", "occ", "grid", "observed_gflops",
                              "target_gflops", "wasted_flop_seconds",
                              "reason", "source")}},
            stack_size=int(cell.get("stack_size", 0)),
            kind=self.kind)

    # ------------------------------------------------------- background

    def start(self) -> None:
        """Start the background cycle thread (idempotent)."""
        if self.running:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="dbcsr-tpu-torch-tune", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.cycle()
            except Exception as exc:  # the loop must survive anything
                self._note(last_error=f"{type(exc).__name__}: {exc}")


# -------------------------------------------------------------- module

def get_service(create: bool = True, **kwargs) -> Optional[TuneService]:
    """The process's tuner singleton (created on first call unless
    ``create=False``)."""
    global _service
    with _lock:
        if _service is None and create:
            _service = TuneService(**kwargs)
        return _service


def current_service() -> Optional[TuneService]:
    """The live service or None — the obs read seam (never creates)."""
    return _service


def maybe_start_from_env() -> Optional[TuneService]:
    """Start the background tuner when ``DBCSR_TPU_TORCH_TUNE`` is truthy
    (the serve engine's start hook).  Returns the service (or None
    when the knob is off)."""
    if os.environ.get("DBCSR_TPU_TORCH_TUNE", "") not in ("1", "on", "true"):
        return None
    svc = get_service()
    svc.start()
    return svc


def stop_service() -> None:
    """Stop and drop the singleton (serve shutdown, tests)."""
    global _service
    with _lock:
        svc, _service = _service, None
    if svc is not None:
        svc.stop()
