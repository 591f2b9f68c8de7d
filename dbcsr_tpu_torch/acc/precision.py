"""The precision planner: demoted compute dtypes, certified by ABFT.

The port's copy of `dbcsr_tpu/acc/precision.py`.  A stack may run with
its A and B blocks demoted to a narrower compute dtype while it sums in
the wide one, optionally with the two-product compensation (hi/lo
splits that restore every cross term but lo*lo).  A spec is
``(compute_dtype_name, compensated)``; None is native.  On the card the
demoted forms are K1's (`acc/stack_kernel.py`); on the CPU its plain
version computes them.

The knob is ``precision`` in `core.config`:

* "native": nothing demotes (the default).
* "adaptive": eligible stacks demote by `default_spec`, only while the
  ABFT plane is on (`acc/abft.py`): every demoted launch is probed, and
  a residual above `obs.costmodel.demoted_abft_tolerance` promotes its
  (m, n, k, dtype) cell back to native for the process
  (`note_exceeded`), and the launch re-executes natively
  (`acc.smm._promote_execute`).  An iterative model opens a
  `chain_scope`, which turns the rest of the chain native once its
  convergence measure falls below the demoted error floor, publishing
  one ``precision_schedule`` event per iteration.
* "f32"/"bf16": force the compensated demoted form, no certificate.

`default_spec` is the JAX package's policy as it reads off a TPU, which
the H100 is: float64 demotes to plain float32 (``("float32", False)``:
where float64 is native "the demotion IS the saving", and the probe
certifies the plain float32 error), float32 stays native (its bf16
demotion applies on a TPU only), complex never demotes.  A tuned row's
``precision`` column (`acc/params.py`) overrides it per cell.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.core.config import get_config
from dbcsr_tpu_torch.core.kinds import dtype_of, name_of
from dbcsr_tpu_torch.obs import costmodel as _costmodel
from dbcsr_tpu_torch.obs import events as _events
from dbcsr_tpu_torch.obs import metrics as _metrics

_lock = threading.Lock()

# (m, n, k, dtype name) -> {"state": "demoted"|"promoted", "last_rel_err",
# "max_rel_err", "launches"}
_cells: dict = {}
# bumped on every state change (a promotion, a chain scope's transition):
# the multiply's plan cache keys on it through `plan_token`
_generation = 0

_tls = threading.local()

# a params-table column value -> (compute dtype, its byte width); a
# trailing "c" selects the compensated form
_COLUMN_COMPUTE = {"f32": ("float32", 4), "bf16": ("bfloat16", 2)}


def _bump() -> None:
    global _generation
    _generation += 1


def generation() -> int:
    return _generation


def _scopes() -> list:
    st = getattr(_tls, "scopes", None)
    if st is None:
        st = _tls.scopes = []
    return st


def plan_token() -> tuple:
    """The precision state a cached stack plan depends on: the mode, the
    generation, and the innermost active chain scope's demand (an
    inactive scope leaves the token alone, so native mode keeps its
    plan-cache hits)."""
    st = _scopes()
    return (get_config().precision, _generation,
            st[-1].mode if st and st[-1].active else None)


# ------------------------------------------------------------------ policy
def _abft_on() -> bool:
    return get_config().abft != "off"


def default_spec(dtype) -> Optional[tuple]:
    """The adaptive policy's demotion target for a request dtype, or None
    when it is ineligible: float64 -> ("float32", False); float32,
    bfloat16 and complex stay native (off a TPU)."""
    return ("float32", False) if dtype_of(dtype) == torch.float64 else None


def _forced_spec(mode: str, dtype) -> Optional[tuple]:
    d = dtype_of(dtype)
    if mode == "f32":
        return ("float32", True) if d == torch.float64 else None
    if mode == "bf16" and d in (torch.float64, torch.float32):
        return ("bfloat16", True)
    return None


def forced() -> bool:
    """True under the forced modes ("f32"/"bf16"), which outrank even a
    tuned host-driver row; adaptive demotion defers to it."""
    return get_config().precision in ("f32", "bf16")


def resolve(m: int, n: int, k: int, dtype, tuned: Optional[dict] = None) -> Optional[tuple]:
    """The spec one stack plan runs with, or None for native: config force
    > chain-scope demand > the tuned row's ``precision`` column > the
    cell's state > `default_spec`."""
    mode = get_config().precision
    if mode == "native":
        return None
    d = dtype_of(dtype)
    if d.is_complex:
        return None
    if mode in ("f32", "bf16"):
        return _forced_spec(mode, d)
    if not _abft_on():  # adaptive: no certificate, no demotion
        return None
    st = _scopes()
    if st and st[-1].mode == "native":
        return None
    info = _cells.get((int(m), int(n), int(k), name_of(d)))
    if info is not None and info["state"] == "promoted":
        return None
    if tuned and tuned.get("precision"):
        col = str(tuned["precision"])
        if col == "native":
            return None
        spec = column_spec(col, d)
        if spec is not None:
            return spec
    return default_spec(d)


def column_spec(col: str, dtype) -> Optional[tuple]:
    """A params-table ``precision`` value ("f32"/"bf16", "c" appended for
    the compensated form) as a spec; None when unknown or when it would
    not narrow the request dtype."""
    comp = col.endswith("c")
    entry = _COLUMN_COMPUTE.get(col[:-1] if comp else col)
    if entry is None:
        return None
    compute, width = entry
    if width >= dtype_of(dtype).itemsize:
        return None
    return (compute, comp)


# -------------------------------------------------------- adaptive feedback
def note_launch(requested: str, spec: tuple) -> None:
    """Count one demoted launch."""
    _metrics.counter(
        "dbcsr_tpu_precision_launches_total",
        "stack launches executed at a demoted compute dtype, by requested/compute "
        "dtype and compensation",
    ).inc(requested=str(requested), compute=spec[0], compensated=str(bool(spec[1])).lower())


def _cell(cell) -> dict:
    return _cells.setdefault(cell, {"state": "demoted", "last_rel_err": 0.0,
                                    "max_rel_err": 0.0, "launches": 0})


def note_probe_ok(cells, rel_err: float) -> None:
    """A demoted launch's probe passed: keep each cell's last and worst
    residual."""
    with _lock:
        for cell in cells or ():
            info = _cell(cell)
            info["last_rel_err"] = float(rel_err)
            info["max_rel_err"] = max(info["max_rel_err"], float(rel_err))
            info["launches"] += 1


def note_exceeded(cells, rel_err: float, ceiling: float) -> None:
    """A demoted launch's residual breached its ceiling: promote each cell
    to native for the process, bump the generation, count and publish
    each promotion (finite residuals only, so the events stay JSON)."""
    rel = float(rel_err) if np.isfinite(rel_err) else None
    promoted = []
    with _lock:
        for cell in cells or ():
            info = _cell(cell)
            if rel is not None:
                info["last_rel_err"] = rel
                info["max_rel_err"] = max(info["max_rel_err"], rel)
            if info["state"] != "promoted":
                info["state"] = "promoted"
                promoted.append(cell)
        if promoted:
            _bump()
    for m, n, k, dt in promoted:
        _metrics.counter(
            "dbcsr_tpu_precision_promotions_total",
            "(m,n,k,dtype) cells promoted back to native compute after a probe "
            "residual breached its demotion ceiling",
        ).inc(dtype=dt)
        _events.publish("precision_promote",
                        {"mnk": f"{m}x{n}x{k}", "dtype": dt, "rel_err": rel,
                         "ceiling": float(ceiling), "why": "probe-ceiling"}, flight=True)


def cells_snapshot() -> dict:
    """{(m, n, k, dtype): {state, last_rel_err, max_rel_err, launches}}."""
    with _lock:
        return {cell: dict(info) for cell, info in _cells.items()}


def reset() -> None:
    """Drop the cells and this thread's chain scopes."""
    with _lock:
        _cells.clear()
    _tls.scopes = []
    _bump()


# ------------------------------------------------------------ chain scopes
class ChainScope:
    """A chain's precision schedule: while ``mode`` is "demoted" its
    stacks may demote; `observe` turns it native once the chain's
    convergence measure falls to the demoted error floor, and publishes
    one ``precision_schedule`` event per observed iteration."""

    __slots__ = ("name", "mode", "active", "floor", "step", "spec")

    def __init__(self, name: str, dtype=None, scale: float = 1.0,
                 promote_below: Optional[float] = None):
        self.name = name
        self.step = 0
        self.spec = None
        if get_config().precision == "adaptive" and _abft_on() and dtype is not None:
            self.spec = default_spec(dtype)
        self.active = self.spec is not None
        self.mode = "demoted" if self.active else "native"
        if promote_below is not None:
            self.floor = float(promote_below)
        elif self.spec is not None:
            # ~eps_eff relative error per product: within 64x of it
            # (scaled to the chain's measure) demoted steps stall
            self.floor = 64.0 * _costmodel.effective_epsilon(*self.spec) * float(scale)
        else:
            self.floor = 0.0

    def observe(self, delta: float) -> None:
        """Record one iteration's convergence measure; may promote."""
        if not self.active:
            return
        self.step += 1
        finite = bool(np.isfinite(delta))
        promote = self.mode == "demoted" and finite and abs(float(delta)) <= self.floor
        if promote:
            self.mode = "native"
            _bump()
        _events.publish("precision_schedule",
                        {"chain": self.name, "step": self.step, "precision": self.mode,
                         # null, not inf: a chain's first step has no previous iterate
                         "delta": float(delta) if finite else None, "floor": float(self.floor),
                         **({"promoted": True} if promote else {})})


@contextlib.contextmanager
def chain_scope(name: str, dtype=None, scale: float = 1.0,
                promote_below: Optional[float] = None):
    """Open a chain's precision scope around an iterative model (purify,
    sign, invsqrt); inert (no events, native) unless the adaptive mode
    and ABFT are on and the dtype demotes."""
    scope = ChainScope(name, dtype=dtype, scale=scale, promote_below=promote_below)
    _scopes().append(scope)
    if scope.active:
        _bump()  # entering a demoting scope re-keys the cached plans
    try:
        yield scope
    finally:
        st = _scopes()
        if st and st[-1] is scope:
            st.pop()
        if scope.active:
            _bump()
