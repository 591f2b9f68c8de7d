"""Batched small-matrix multiply over parameter stacks, guarded by the
integrity plane.

Counterpart of `dbcsr_tpu/acc/smm.py` (ref `libsmm_acc_process`,
`src/acc/acc_libsmm.h`).  A parameter stack is three index arrays of
length S, sorted by ``c_idx``; entry s means

    C[c_idx[s]] += alpha * A[a_idx[s]] @ B[b_idx[s]]

with A an (Na, m, k) bin, B (Nb, k, n) and C (Nc, m, n).  `prepare_stack`
picks the driver, turns the sorted stack into its layout and uploads
it; `execute_stack` runs it, in place on C.  The drivers, by the
config's names (`core.config.mm_driver`), which the fault specs, the
breakers and the counters use:

* ``pallas``: the base stack kernel (`acc/stack_kernel.py`, K1), one
  run per destination block (the plan's ``driver`` "kernel");
* ``pallas_cross``: the crosspack kernel (`acc/crosspack_kernel.py`,
  K3, and its operands-resident launch K4), runs dealt into packs of P
  (`acc/crosspack.py`; ``driver`` "crosspack");
* ``torch``: the base kernel's plain PyTorch version on any device;
* ``host``: the native C++ stack driver (`native/host_smm.cpp`), for
  CPU tensors only; a CUDA tensor raises (the JAX package warns and
  picks another driver instead, `acc/smm.py:570-580`).

The choice follows the JAX package's `_prepare_stack_impl`
(`dbcsr_tpu/acc/smm.py:680-804`): crosspack when ``"pallas_cross"``
forces it, when the tuned table (`acc/params.py`) says
``crosspack``/``crosspack_vmem``, or under ``"auto"`` for an untuned
float32 or bfloat16 stack on the card; float64 stays on the base kernel
unless forced or tuned, a pack of P <= 1 takes the base kernel, and so
does a shape whose crosspack launch failed deterministically
(`_cross_disabled`).  The first launch per (m, n, k, dtype, device) --
per (m, n, k, dtype, device, variant, pack) for crosspack -- is checked
against a float64 host oracle; a mismatch raises `KernelValidationError`.

**The guard** (`execute_stack`, ref `dbcsr_tpu/acc/smm.py:952-1345`).
Fault hooks fire at ``prepare_stack`` and ``execute_stack``
(`resilience/faults.py`); a per-(driver, shape) breaker admits each
launch (`resilience/breaker.py`); a finite-output check runs while
faults are active or ``DBCSR_TPU_TORCH_CHECK_OUTPUTS=1`` was set at
import; the ABFT probe runs while ``abft`` is on (`acc/abft.py`).  A
failure is classified (``validation``, ``sdc``, ``nan``, ``oom``,
``runtime``), counted (``dbcsr_tpu_driver_failures_total{driver,kind}``,
a ``driver_failure`` event and a flight note) and recorded against the
breaker, and the stack re-executes down the failover chain: an ``sdc``
first retries the same driver, then each admitted driver runs from the
pristine C until one succeeds (``dbcsr_tpu_driver_fallback_total``, a
``driver_failover`` event), and the cached plan heals in place to that
driver.  On the card the chain holds the hand-written kernels only
(pallas_cross -> pallas): a stack on CUDA tensors never gives way to the
plain version, and raises when no kernel admits it.  CPU tensors go on
to torch and host (``_FAILOVER_CHAIN``).  A crosspack launch that fails
with a runtime error demotes its shape for the session; an
out-of-memory failure is transient and demotes nothing.  Two failures
never enter the chain and always reach the caller: a library that fails
to build (`acc.build.BuildError`) and a kernel that fails its first-use
check (`KernelValidationError`; the JAX package fails such a kernel
over).

The kernels write C in place, so while any check or fault is active the
guard keeps a clone of the C bin from before the launch (none for a
``c_zero`` launch into a zero bin, which restores by zeroing), and every
retry or failover starts from it.  With no fault configured, ABFT off
and no breaker ever tripped, a launch costs a few attribute checks: no
clone and no host sync.

**Precision** (`acc/precision.py`; ref `dbcsr_tpu/acc/smm.py:587-651,
1221-1258`).  Unless the config forces a driver ("pallas",
"pallas_cross", "host"), planning resolves the stack's compute spec; a
demoted plan (``plan.precision``) runs on K1's demoted form (the JAX
package's XLA family), or on the plain version where the config asks
for "torch" or the tensor lies on the CPU, and never on crosspack.  A
tuned ``host`` row outranks adaptive demotion, not the forced modes.
Each demoted launch is counted (``dbcsr_tpu_precision_launches_total``)
and probed against its demotion ceiling; a breach
(`abft.PrecisionExceededError`) is no corruption: the stack re-plans
natively, heals the cached plan and re-executes from the pristine C,
with no breaker or failover (`_promote_execute`).

**Superstack** (`execute_superstack`, ref
`dbcsr_tpu/acc/smm.py:1558-1992`): the spans of one C bin run as one
fused launch of K1 (`stack_kernel.smm_superstack`), bit for bit the
per-span launches, under the same guard with its own ``fused`` breaker;
a failed fused launch decomposes into `execute_stack` per span.

**Complex** stacks run on K1's complex forms (both its paths) on the
card, on the plain version or the host driver on the CPU, never on
crosspack: ``mm_driver="pallas_cross"`` or a crosspack variant on a
complex stack raises `TypeError`, as ``"host"`` does for bf16.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch import native
from dbcsr_tpu_torch.acc import abft, crosspack_kernel, params, stack_kernel
from dbcsr_tpu_torch.acc import precision as _precision
from dbcsr_tpu_torch.acc.build import BuildError
from dbcsr_tpu_torch.acc.crosspack import choose_pack, prepare_crosspack, runs, supports_resident
from dbcsr_tpu_torch.core.config import get_config
from dbcsr_tpu_torch.core.kinds import name_of
from dbcsr_tpu_torch.core.matrix import to_host
from dbcsr_tpu_torch.obs import events, flight, metrics, tracer
from dbcsr_tpu_torch.obs.costmodel import form_tolerance
from dbcsr_tpu_torch.resilience import breaker, faults

# kernels that passed first-use validation: (m, n, k, dtype, device type)
# for the base kernel, plus (variant, pack) for crosspack (ref
# libsmm_acc.cpp:81-85,216)
_validated_kernels: set = set()
_VALIDATE_MAX_ENTRIES = 512

_VARIANTS = (None, "kmerge", "crosspack", "crosspack_vmem")
_CROSS_VARIANTS = ("crosspack", "crosspack_vmem")

# the failover chain of a CPU stack, fastest first ("host" serves CPU
# tensors only), and of a stack on the card: the hand-written kernels
_FAILOVER_CHAIN = ("pallas_cross", "pallas", "torch", "host")
_CARD_CHAIN = ("pallas_cross", "pallas")
# the config's driver name of each plan driver
_LABELS = {"crosspack": "pallas_cross", "kernel": "pallas", "torch": "torch", "host": "host"}

# shapes (m, n, k, dtype) whose crosspack launch failed deterministically:
# they take the base kernel for the session (ref the unsupported-kernel
# fallback, libsmm_acc.cpp:227-249; dbcsr_tpu/acc/smm.py:1470-1505)
_cross_disabled: set = set()

# production finite-output checking is an opt-in read once at import: a
# per-launch environment lookup would sit on the hot path
_CHECK_OUTPUTS_ENV = os.environ.get("DBCSR_TPU_TORCH_CHECK_OUTPUTS") == "1"


class KernelValidationError(RuntimeError):
    """A stack kernel disagreed with the float64 host oracle."""


class CorruptedOutputError(RuntimeError):
    """A stack driver left non-finite values in C (the finite-output
    check)."""


class StackPlan:
    """A prepared stack: device index arrays in the chosen kernel's layout.

    ``driver`` is "kernel" (`stack_kernel.smm_stack`), "torch" (its plain
    version on any device), "crosspack" (`crosspack_kernel.smm_crosspack`,
    with ``pack`` = (P, R), the ``pack_runs`` layout, and ``resident``
    for the launch that keeps the operand bin ``window`` in persisting
    L2) or "host" (`native.host_smm`, CPU tensors, with ``host_idx`` the
    stack's host (a, b, c) arrays); ``label`` is its config name.  The
    kernels run their plain versions on a CPU tensor.  ``precision`` is
    the demoted compute spec the plan runs with (None: native)."""

    __slots__ = ("driver", "a_idx", "b_idx", "run_ptr", "run_c", "entries",
                 "nruns", "max_run", "n_a", "n_b", "pack", "pack_runs", "pack_longest",
                 "resident", "window", "val_idx", "host_idx", "precision")

    def __init__(self):
        self.driver = "kernel"
        self.a_idx = self.b_idx = self.run_ptr = self.run_c = None
        self.entries = 0
        self.nruns = 0
        self.max_run = 0
        self.n_a = self.n_b = 0  # distinct A and B blocks the stack reads
        self.pack = None          # crosspack: (P, R)
        self.pack_runs = None     # crosspack: int32 (npacks * P,), -1 = empty
        self.pack_longest = None  # crosspack: host, longest run of each pack
        self.resident = False     # crosspack: the K4 launch
        self.window = "a"         # crosspack, resident: the bin kept in L2
        self.val_idx = None  # host (a, b, c) prefix for first-use validation
        self.host_idx = None  # host int32 (a, b, c): the host driver's stack
        self.precision = None  # demoted compute spec (acc/precision.py)

    @property
    def label(self) -> str:
        """The driver's config name: "pallas_cross", "pallas", "torch" or
        "host"."""
        return _LABELS[self.driver]

    @property
    def kernel(self) -> str:
        """The kernel this plan launches on a CUDA tensor."""
        if self.driver == "crosspack":
            return "smm_crosspack_resident" if self.resident else "smm_crosspack"
        return {"kernel": "smm_stack", "host": "host_smm"}.get(self.driver, "plain")

    def nbytes(self) -> int:
        """Bytes the plan pins: its device index arrays and the host index
        arrays kept for validation or the host driver (the plan cache's
        budget)."""
        arrays = (self.a_idx, self.b_idx, self.run_ptr, self.run_c, self.pack_runs)
        n = sum(t.numel() * t.element_size() for t in arrays if t is not None)
        for host in (self.val_idx, self.host_idx):
            if host is not None:
                n += sum(x.nbytes for x in host)
        return n

    def stack(self) -> tuple:
        """The stack's int64 (a, b, c) index arrays, read back from the
        plan's arrays (C's index from the runs), from which the failover
        plans it again for another driver: one copy to the host, paid
        only on a failover."""
        run_len = np.diff(self.run_ptr.cpu().numpy().astype(np.int64))
        c_idx = np.repeat(self.run_c.cpu().numpy().astype(np.int64), run_len)
        return (self.a_idx.cpu().numpy().astype(np.int64),
                self.b_idx.cpu().numpy().astype(np.int64), c_idx)


def _upload(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)


def _on_card(c_data) -> bool:
    """Whether the stack lies on the card (the port's reading of the JAX
    package's `_on_tpu` dispatch gate; the CPU tests patch it)."""
    return c_data.device.type == "cuda"


def _stack_shape_key(c_data, a_data, b_data) -> tuple:
    """(m, n, k, dtype) of a stack: the breakers' key and the demotion's."""
    return (a_data.shape[1], b_data.shape[2], a_data.shape[2], name_of(c_data.dtype))


def _crosspack_choice(driver, c_data, a_data, b_data, s, variant, pack):
    """(pack, resident) when the stack takes the crosspack kernel, else
    None: the rules of `dbcsr_tpu/acc/smm.py:680-771` under ``driver``
    (the config's ``mm_driver``), without the TPU's bf16 guard (:704-717).
    A demoted shape takes the base kernel unless ``variant`` forces
    crosspack."""
    if c_data.dtype.is_complex:
        return None  # complex stacks run on the base kernel
    if variant == "kmerge" or (variant is None and driver in ("pallas", "torch")):
        return None
    if variant is None and _stack_shape_key(c_data, a_data, b_data) in _cross_disabled:
        return None
    m, k = a_data.shape[1:]
    n = b_data.shape[2]
    tuned = params.predict(m, n, k, c_data.dtype, stack_size=s)
    tuned_cross = bool(tuned) and tuned.get("driver") == "pallas" \
        and tuned.get("variant") in _CROSS_VARIANTS
    if variant is None:
        auto_cross = (driver == "auto" and tuned is None and _on_card(c_data)
                      and c_data.dtype != torch.float64)
        if not (driver == "pallas_cross" or (driver == "auto" and tuned_cross) or auto_cross):
            return None
    if pack is None:
        if (tuned and tuned.get("pack_p") and tuned.get("grouping")
                and "predicted_from" not in tuned):
            # an exact row, clamped to this shape's geometry (:736-745)
            pack = (min(int(tuned["pack_p"]), max(1, 128 // max(m, n))),
                    min(int(tuned["grouping"]), max(1, 128 // k)))
        else:
            # a donor's pack was tuned for another shape (:746-750)
            pack = choose_pack(m, n, k)
    want_resident = (variant == "crosspack_vmem" if variant is not None
                     else bool(tuned) and tuned.get("variant") == "crosspack_vmem")
    return tuple(pack), want_resident and supports_resident(a_data, b_data)


def _check_stack_args(c_data, a_data, b_data, a_idx, b_idx, c_idx, variant):
    """Validate a stack; returns its int64 index arrays."""
    if variant not in _VARIANTS:
        raise ValueError(f"unknown stack kernel variant {variant!r}")
    a_idx = np.asarray(a_idx, np.int64)
    b_idx = np.asarray(b_idx, np.int64)
    c_idx = np.asarray(c_idx, np.int64)
    s = len(a_idx)
    if len(b_idx) != s or len(c_idx) != s:
        raise ValueError("a_idx/b_idx/c_idx lengths differ")
    if s == 0:
        return a_idx, b_idx, c_idx
    if s >= 2 ** 31:
        raise ValueError(f"stack of {s} entries exceeds the int32 index range")
    if np.any(np.diff(c_idx) < 0):
        raise ValueError("stack must be sorted by c_idx")
    for name, idx, bound in (("a_idx", a_idx, a_data.shape[0]),
                             ("b_idx", b_idx, b_data.shape[0]),
                             ("c_idx", c_idx, c_data.shape[0])):
        if idx.min() < 0 or idx.max() >= bound:
            raise IndexError(f"{name} out of range [0, {bound})")
    return a_idx, b_idx, c_idx


def _check_host(c_data) -> None:
    """The host driver serves float32/float64 CPU tensors only: a stack
    elsewhere raises rather than change device in silence."""
    if c_data.device.type != "cpu":
        raise ValueError(f"mm_driver='host' serves CPU tensors only; C is on {c_data.device}")
    if not native.host_smm_supports(c_data.dtype):
        raise TypeError(f"mm_driver='host' takes float32/float64/complex64/complex128, "
                        f"got {c_data.dtype}")


def prepare_stack(c_data, a_data, b_data, a_idx, b_idx, c_idx,
                  variant: Optional[str] = None, pack=None) -> Optional[StackPlan]:
    """Host side: check the stack, pick the driver, build its layout and
    upload the int32 arrays.  ``variant`` forces a kernel ("kmerge": the
    base kernel; "crosspack"/"crosspack_vmem": crosspack, the resident
    launch while `supports_resident` holds) and ``pack`` forces (P, R).
    Returns None for an empty stack.  A planning failure (the
    ``prepare_stack`` fault site, or a real one) is counted and the stack
    is planned again on the safe driver, as the JAX package plans it
    again on its XLA driver: the base kernel on the card (the plain
    version only where the config asks for it), the plain version on
    the CPU."""
    a_idx, b_idx, c_idx = _check_stack_args(c_data, a_data, b_data, a_idx, b_idx, c_idx,
                                            variant)
    if len(a_idx) == 0:
        return None
    # a refused request raises, never re-plans
    if variant is None and get_config().mm_driver == "host":
        _check_host(c_data)
    if c_data.dtype.is_complex and (variant in _CROSS_VARIANTS or (
            variant is None and get_config().mm_driver == "pallas_cross")):
        raise TypeError(f"the crosspack kernel takes no {c_data.dtype} stack "
                        f"(complex stacks run on the base kernel)")
    try:
        if faults.active():
            faults.maybe_inject("prepare_stack")
        plan = _prepare_stack_impl(c_data, a_data, b_data, a_idx, b_idx, c_idx,
                                   variant=variant, pack=pack)
    except BuildError:
        raise
    except Exception as exc:  # noqa: BLE001 -- classified, counted, re-planned
        shape_key = _stack_shape_key(c_data, a_data, b_data)
        _record_driver_failure("prepare", _classify_failure(exc), exc, shape_key)
        safe = ("pallas" if _on_card(c_data) and get_config().mm_driver != "torch"
                else "torch")
        plan = _prepare_stack_impl(c_data, a_data, b_data, a_idx, b_idx, c_idx,
                                   driver=safe)
        _record_fallback("prepare", plan.label, shape_key)
    return plan


def _prepare_stack_impl(c_data, a_data, b_data, a_idx, b_idx, c_idx,
                        variant: Optional[str] = None, pack=None,
                        driver: Optional[str] = None) -> StackPlan:
    """Driver selection and plan construction for a checked, non-empty
    stack; ``driver`` stands in for the config's ``mm_driver`` (the
    failover forces one chain driver this way)."""
    cfg = get_config()
    driver = driver or cfg.mm_driver
    s = len(a_idx)
    dev = c_data.device
    plan = StackPlan()
    prec = None
    if variant is None and driver not in ("pallas", "pallas_cross", "host"):
        m, k = a_data.shape[1:]
        tuned = params.predict(m, b_data.shape[2], k, c_data.dtype, stack_size=s)
        prec = _precision.resolve(m, b_data.shape[2], k, c_data.dtype, tuned=tuned)
        if (driver == "auto" and tuned and tuned.get("driver") == "host"
                and c_data.device.type == "cpu" and native.host_smm_supports(c_data.dtype)
                and (prec is None or not _precision.forced())):
            # a tuned host row outranks adaptive demotion, not the forced
            # modes (dbcsr_tpu/acc/smm.py:601-617)
            prec, driver = None, "host"
    if driver == "host" and variant is None:
        _check_host(c_data)
        plan.driver = "host"
        plan.host_idx = tuple(np.ascontiguousarray(x, np.int32) for x in (a_idx, b_idx, c_idx))
        run_ptr, run_c = runs(c_idx)
    elif prec is not None:
        # a demoted plan: K1's demoted form (the plain version where the
        # config asks for "torch"), never crosspack; the span records the
        # precision the stack computes in, not the one requested
        # (dbcsr_tpu/acc/smm.py:617)
        tracer.annotate(precision=f"{prec[0]}{'+comp' if prec[1] else ''}")
        plan.driver = "torch" if driver == "torch" else "kernel"
        plan.precision = tuple(prec)
        run_ptr, run_c = runs(c_idx)
    else:
        choice = _crosspack_choice(driver, c_data, a_data, b_data, s, variant, pack)
        layout = prepare_crosspack(c_idx, choice[0]) if choice else None
        if layout is not None:
            plan.driver = "crosspack"
            plan.pack = (layout.P, layout.R)
            plan.resident = choice[1]
            # one window per launch: the bin with more re-reads per byte,
            # i.e. the one with fewer blocks (every entry reads one of each)
            plan.window = "a" if a_data.shape[0] <= b_data.shape[0] else "b"
            plan.pack_runs = _upload(layout.pack_runs, dev)
            plan.pack_longest = layout.pack_longest
            run_ptr, run_c = layout.run_ptr, layout.run_c
        else:
            plan.driver = "torch" if variant is None and driver == "torch" else "kernel"
            run_ptr, run_c = runs(c_idx)
    plan.a_idx = _upload(a_idx, dev)
    plan.b_idx = _upload(b_idx, dev)
    plan.run_ptr = _upload(run_ptr, dev)
    plan.run_c = _upload(run_c, dev)
    plan.entries = s
    plan.nruns = len(run_c)
    plan.max_run = int(np.diff(run_ptr).max())
    plan.n_a = int(np.count_nonzero(np.bincount(a_idx)))
    plan.n_b = int(np.count_nonzero(np.bincount(b_idx)))
    if plan.driver in ("kernel", "crosspack") and cfg.validate_kernels:
        p = min(s, _VALIDATE_MAX_ENTRIES)
        plan.val_idx = (a_idx[:p], b_idx[:p], c_idx[:p])
    flight.note_driver(plan.label, driver if variant is None else f"variant:{variant}",
                       mnk=_stack_shape_key(c_data, a_data, b_data)[:3], entries=s)
    if plan.precision is not None:
        flight.note("precision", f"{prec[0]}{'+comp' if prec[1] else ''}")
    return plan


# ------------------------------------------------------------------ the guard
def _classify_failure(exc: BaseException) -> str:
    """The failure class the breakers and
    ``dbcsr_tpu_driver_failures_total{driver,kind}`` use."""
    if isinstance(exc, KernelValidationError):
        return "validation"
    if isinstance(exc, abft.AbftMismatchError):
        return "sdc"
    if isinstance(exc, CorruptedOutputError):
        return "nan"
    msg = f"{type(exc).__name__}: {exc}"
    if isinstance(exc, torch.cuda.OutOfMemoryError) or "out of memory" in msg.lower():
        return "oom"
    return "runtime"


def _output_checks_enabled() -> bool:
    """The finite-output check: on while faults are active, or with
    ``DBCSR_TPU_TORCH_CHECK_OUTPUTS=1`` at import (one reduction and one
    host sync per launch)."""
    return _CHECK_OUTPUTS_ENV or faults.active()


def _output_corrupted(out: torch.Tensor) -> bool:
    return not bool(torch.isfinite(out.sum(dim=tuple(range(1, out.dim())))).all())


def _record_driver_failure(driver: str, kind: str, exc, shape_key) -> None:
    metrics.counter("dbcsr_tpu_driver_failures_total",
                    "stack-driver execution failures by driver and failure kind",
                    ).inc(driver=driver, kind=kind)
    err = f"{type(exc).__name__}: {exc}"[:200]
    events.publish("driver_failure",
                   {"driver": driver, "kind": kind,
                    "shape": "x".join(str(x) for x in shape_key), "error": err},
                   flight=("driver_failure", {"driver": driver, "kind": kind, "error": err}))


def _record_fallback(from_driver: str, to_driver: str, shape_key) -> None:
    metrics.counter("dbcsr_tpu_driver_fallback_total",
                    "stacks re-executed on a safer driver after a chain failover",
                    ).inc(**{"from": from_driver, "to": to_driver})
    events.publish("driver_failover",
                   {"from": from_driver, "to": to_driver,
                    "shape": "x".join(str(x) for x in shape_key)},
                   flight=("failover", {"from": from_driver, "to": to_driver}))


# the failover chain each recorded breaker's stacks take: "card" or
# "cpu", keyed like the board's snapshot ("driver|MxNxKxdtype"); the
# health model's ``drivers`` component maps its backstop rule onto it
_breaker_chains: dict = {}


def breaker_chain(key: str) -> Optional[str]:
    """"card" or "cpu" for a breaker key of `BreakerBoard.snapshot`,
    None when no stack recorded a failure under it."""
    return _breaker_chains.get(key)


def _record_failure(driver: str, shape_key, exc, c_data=None) -> str:
    """Classify a failed launch of ``driver`` and record it (breaker,
    counter, event, and the chain ``c_data``'s stacks take); a crosspack
    launch that failed to run demotes its shape, for the session unless
    the failure was out of memory.  Returns the class."""
    kind = _classify_failure(exc)
    breaker.get_board().record_failure(driver, shape_key, kind=kind)
    if c_data is not None:
        _breaker_chains[f"{driver}|{'x'.join(str(x) for x in shape_key)}"] = \
            "card" if _on_card(c_data) else "cpu"
    _record_driver_failure(driver, kind, exc, shape_key)
    if driver == "pallas_cross" and kind in ("runtime", "oom"):
        if kind == "runtime":
            _cross_disabled.add(shape_key)
        events.publish("crosspack_demoted",
                       {"shape": "x".join(str(x) for x in shape_key), "kind": kind,
                        "session": kind == "runtime"}, flight=True)
    return kind


def note_deferred_sdc(exc: BaseException) -> None:
    """Charge a mismatch found by `abft.flush` to its driver's breaker and
    the failure counters, as an immediate check would have."""
    drv = getattr(exc, "driver", None) or "?"
    key = getattr(exc, "shape_key", None) or (drv, "deferred")
    breaker.get_board().record_failure(drv, key, kind="sdc")
    _record_driver_failure(drv, "sdc", exc, key)


def _chain_candidates(failed: str, c_data) -> list:
    """Every other driver that can run this stack, faster ones first: the
    chain after ``failed``, then the drivers before it, nearest first.
    On the card the chain holds the hand-written kernels only.  Breaker
    admission is checked per attempt."""
    chain = _CARD_CHAIN if _on_card(c_data) else _FAILOVER_CHAIN
    try:
        i = chain.index(failed)
        rest = chain[i + 1:] + tuple(reversed(chain[:i]))
    except ValueError:  # a driver outside the chain ("torch" on the card)
        rest = chain
    return [drv for drv in rest if drv != failed
            and (drv != "host" or native.host_smm_supports(c_data.dtype))]


def _restore(c_data, base, c_zero: bool) -> None:
    """Put the pristine C back before a retry: zeros for a ``c_zero``
    launch, else the clone taken before the first attempt (the in-place
    write bumps the bin's version, so caches keyed on it miss)."""
    if c_zero:
        c_data.zero_()
    else:
        c_data.copy_(base)


def _attempt(c_data, base, a_data, b_data, plan: StackPlan, alpha, c_zero: bool,
             restore: bool = True, defer: bool = False, shape_key=None) -> None:
    """One guarded attempt of ``plan``: the pristine C restored (not on a
    first try), the fault hook, the launch, the corrupting fault hook,
    the finite-output check and the ABFT check (deferred to the caller's
    `abft.flush` when ``defer`` and ``c_zero``).  Raises what condemns
    it."""
    if restore:
        _restore(c_data, base, c_zero)
    faults_on = faults.active()
    if faults_on:
        faults.maybe_inject("execute_stack", driver=plan.label)
    _execute_plan(c_data, a_data, b_data, plan, alpha)
    if faults_on:
        faults.corrupt("execute_stack", c_data, driver=plan.label)
    # the ABFT probe catches non-finite values too, so the finite check
    # runs only under faults or the opt-in
    if _output_checks_enabled() and _output_corrupted(c_data):
        raise CorruptedOutputError(f"driver {plan.label!r} produced non-finite output blocks")
    if abft.enabled():
        abft.check_stack(base, c_data, a_data, b_data, plan, alpha, c_zero=c_zero,
                         defer=defer and c_zero, shape_key=shape_key)


def _accepted(failed: str, drv: str, shape_key, sdc_count: int) -> None:
    """Book a re-execution on ``drv`` that passed its checks: the breaker's
    success, the fallback, and one ABFT recovery per counted mismatch (so
    the mismatch and recovery counters stay balanced)."""
    breaker.get_board().record_success(drv, shape_key)
    _record_fallback(failed, drv, shape_key)
    for _ in range(sdc_count):
        abft.record_recovery(drv)


def _replan(plan: StackPlan, c_data, a_data, b_data, drv: str) -> Optional[StackPlan]:
    """``plan``'s stack planned again for chain driver ``drv``; None when
    the selection refuses the force (P <= 1, a demoted shape)."""
    fb = _prepare_stack_impl(c_data, a_data, b_data, *plan.stack(), driver=drv)
    return fb if fb.label == drv else None


def _failover_execute(c_data, a_data, b_data, plan: StackPlan, alpha, c_zero: bool,
                      exc: Optional[BaseException], base):
    """Re-execute a failed (``exc``) or quarantined (``exc`` None) stack
    down the chain, from the pristine C; ``base`` is its clone, None when
    none was taken (a ``c_zero`` launch, or one no check could condemn
    after it wrote, so C is still pristine).  On success the plan heals
    in place to the driver that ran it.  A kernel that fails its
    first-use check ends the chain: its error reaches the caller."""
    board = breaker.get_board()
    failed = plan.label
    shape_key = _stack_shape_key(c_data, a_data, b_data)
    if base is None and not c_zero:
        base = c_data.clone()
    was_sdc = exc is not None and _classify_failure(exc) == "sdc"
    sdc_count = 1 if was_sdc else 0
    # silent corruption is transient: one retry of the same plan from the
    # pristine C reproduces the clean bits before any driver with other
    # numerics runs (the breaker has the sdc failure already)
    tries = ([failed] if was_sdc else []) + _chain_candidates(failed, c_data)
    for n, drv in enumerate(tries):
        retry = was_sdc and n == 0
        if not retry and not board.allow(drv, shape_key):
            continue
        try:
            run = plan if retry else _replan(plan, c_data, a_data, b_data, drv)
            if run is None:
                continue
            _attempt(c_data, base, a_data, b_data, run, alpha, c_zero)
        except BuildError:
            raise
        except Exception as exc2:  # noqa: BLE001 -- classified and recorded
            kind = _record_failure(drv, shape_key, exc2, c_data)
            if kind == "validation":
                _restore(c_data, base, c_zero)
                raise
            sdc_count += kind == "sdc"
            continue
        _accepted(failed, drv, shape_key, sdc_count)
        if run is not plan:
            flight.note_driver(drv, f"failover:{failed}", mnk=shape_key[:3],
                               entries=plan.entries)
            for slot in StackPlan.__slots__:  # cached plans heal too
                setattr(plan, slot, getattr(run, slot))
        return c_data
    if exc is None:
        # quarantined, and nothing else admits it: running the original
        # driver beats refusing the multiply
        _restore(c_data, base, c_zero)
        return _execute_plan(c_data, a_data, b_data, plan, alpha)
    # last resort: one more try of the same driver (a transient fault
    # heals here); on the card no other kernel admitted the stack
    try:
        _attempt(c_data, base, a_data, b_data, plan, alpha, c_zero)
    except BuildError:
        raise
    except Exception:
        _restore(c_data, base, c_zero)
        raise exc
    _accepted(failed, failed, shape_key, sdc_count)
    return c_data


def execute_stack(c_data, a_data, b_data, plan: Optional[StackPlan], alpha=1.0,
                  c_zero: bool = False, abft_defer: bool = False):
    """Device side: run a prepared plan on (possibly new) data, updating
    ``c_data`` in place, guarded as the module docstring says; returns
    it.  ``c_zero``: the caller guarantees ``c_data`` is all zeros (a
    beta = 0 product's first touch of the bin), so no pristine clone is
    needed and the ABFT probe may be deferred (``abft_defer``) to the
    caller's `abft.flush`."""
    if plan is None:
        return c_data
    record_dispatch("per_span")
    board = breaker.get_board()
    shape_key = _stack_shape_key(c_data, a_data, b_data)
    if not board.allow(plan.label, shape_key):
        return _failover_execute(c_data, a_data, b_data, plan, alpha, c_zero, None,
                                 base=None)
    # a check may condemn a launch after it wrote C: keep the pristine bin
    # (the production path -- no fault, ABFT off, no opt-in -- clones nothing)
    checks_on = _output_checks_enabled() or abft.enabled()
    base = c_data.clone() if checks_on and not c_zero else None
    try:
        _attempt(c_data, base, a_data, b_data, plan, alpha, c_zero, restore=False,
                 defer=abft_defer, shape_key=shape_key)
    except BuildError:
        raise
    except abft.PrecisionExceededError as exc:
        # an adaptive promote, not corruption: the cells were promoted
        # when the probe raised; re-execute natively
        return _promote_execute(c_data, a_data, b_data, plan, alpha, c_zero, base, exc)
    except Exception as exc:  # noqa: BLE001 -- classified and recorded
        if _record_failure(plan.label, shape_key, exc, c_data) == "validation":
            raise  # the oracle ran before the launch: C is untouched
        return _failover_execute(c_data, a_data, b_data, plan, alpha, c_zero, exc, base=base)
    board.record_success(plan.label, shape_key)
    return c_data


def _promote_execute(c_data, a_data, b_data, plan: StackPlan, alpha, c_zero: bool, base, exc):
    """A demoted launch's probe breached its ceiling
    (`abft.PrecisionExceededError`; its cells were promoted as it
    raised): plan the stack again, natively, from the plan's own device
    arrays (the plan keeps no host copy), heal the cached plan in place,
    and run it from the pristine C.  No breaker, no failover: the
    condemned result was off by demoted rounding only (ref
    `dbcsr_tpu/acc/smm.py:1221-1258`).  Without a pristine C (no clone
    was taken) the error reaches the caller."""
    if base is None and not c_zero:
        raise exc
    events.publish("precision_promote_reexec",
                   {"driver": plan.label,
                    "shape": "x".join(str(x) for x in _stack_shape_key(c_data, a_data, b_data))},
                   flight=("precision_promote_reexec", {"driver": plan.label}))
    _restore(c_data, base, c_zero)
    new = _prepare_stack_impl(c_data, a_data, b_data, *plan.stack())
    # the forced modes would demote again: the re-execution is native
    new.precision = None
    for slot in StackPlan.__slots__:  # cached plans heal too
        setattr(plan, slot, getattr(new, slot))
    return execute_stack(c_data, a_data, b_data, plan, alpha, c_zero=c_zero)


def _execute_plan(c_data, a_data, b_data, plan: StackPlan, alpha=1.0):
    """Run one plan on its driver, in place on ``c_data`` (the dispatch
    proper; the guard lives in `execute_stack`)."""
    if plan.precision is not None:
        _precision.note_launch(name_of(c_data.dtype), plan.precision)
    if plan.driver == "torch":
        return stack_kernel.smm_stack_plain(
            c_data, a_data, b_data, plan.a_idx, plan.b_idx, plan.run_ptr,
            plan.run_c, alpha, chunk=get_config().mm_stack_size, precision=plan.precision)
    if plan.driver == "host":
        return native.host_smm(c_data, a_data, b_data, *plan.host_idx, alpha)
    _ensure_validated(c_data, a_data, b_data, plan)
    if plan.driver == "crosspack":
        return crosspack_kernel.smm_crosspack(
            c_data, a_data, b_data, plan.a_idx, plan.b_idx, plan.run_ptr,
            plan.run_c, plan.pack_runs, plan.pack, alpha,
            resident=plan.resident, window=plan.window)
    return stack_kernel.smm_stack(c_data, a_data, b_data, plan.a_idx, plan.b_idx,
                                  plan.run_ptr, plan.run_c, alpha, precision=plan.precision)


def _ensure_validated(c_data, a_data, b_data, plan: StackPlan) -> None:
    """Validate the plan's kernel at its shape on first use, and report
    the launch to the first-use mirror (`obs.metrics.record_jit`)."""
    key = (a_data.shape[1], b_data.shape[2], a_data.shape[2],
           name_of(c_data.dtype), c_data.device.type)
    if plan.driver == "crosspack":
        key += ("crosspack_vmem" if plan.resident else "crosspack", plan.pack)
    elif plan.precision is not None:
        key += ("precision", plan.precision)
    metrics.record_jit(plan.kernel, key)
    if plan.val_idx is None or not get_config().validate_kernels:
        return
    if key in _validated_kernels:
        return
    _validate_kernel(c_data, a_data, b_data, plan, *plan.val_idx)
    _validated_kernels.add(key)


def _oracle_products(a: torch.Tensor, b: torch.Tensor, precision) -> np.ndarray:
    """The block products ``a[s] @ b[s]`` a host oracle holds a form
    against, in float64 (complex128): of the operands, or of the parts a
    demoted form multiplies (the operands rounded to the compute dtype,
    or their hi/lo splits without lo*lo, as `stack_kernel.batch_dot`
    takes them), so only the kernel's order of the sums is tested."""
    if precision is None:
        pairs = [(a, b)]
    else:
        cdt = stack_kernel.compute_dtype(precision)
        if precision[1]:
            ah, al = stack_kernel.split_hi_lo(a, cdt)
            bh, bl = stack_kernel.split_hi_lo(b, cdt)
            pairs = [(ah, bh), (ah, bl), (al, bh)]
        else:
            pairs = [(a.to(cdt), b.to(cdt))]
    wide = torch.complex128 if a.dtype.is_complex else torch.float64
    return sum(np.einsum("smk,skn->smn", x.to(wide).cpu().numpy(), y.to(wide).cpu().numpy())
               for x, y in pairs)


def _validate_kernel(c_data, a_data, b_data, plan: StackPlan, ai, bi, ci) -> None:
    """Run the plan's kernel on a stack prefix into a zeroed, compacted C
    (one block per distinct destination of the prefix) and hold it
    against a float64 (complex128) host oracle of the same form (ref
    `validate_kernel`, `libsmm_acc.cpp:216`), within the rounding of
    the form's sums (`obs.costmodel.form_tolerance`)."""
    m, k = a_data.shape[1:]
    n = b_data.shape[2]
    dest, cc = np.unique(ci, return_inverse=True)
    dev = c_data.device
    got = torch.zeros((len(dest), m, n), dtype=c_data.dtype, device=dev)
    a_dev, b_dev = _upload(ai, dev), _upload(bi, dev)
    if plan.driver == "crosspack":
        layout = prepare_crosspack(cc, plan.pack)
        run_ptr = layout.run_ptr
        crosspack_kernel.smm_crosspack(
            got, a_data, b_data, a_dev, b_dev, _upload(run_ptr, dev),
            _upload(layout.run_c, dev), _upload(layout.pack_runs, dev), plan.pack,
            1.0, resident=plan.resident, window=plan.window)
    else:
        run_ptr, run_c = runs(cc)
        stack_kernel.smm_stack(got, a_data, b_data, a_dev, b_dev,
                               _upload(run_ptr, dev), _upload(run_c, dev), 1.0,
                               precision=plan.precision)
    wide = np.complex128 if c_data.dtype.is_complex else np.float64
    ref = np.zeros((len(dest), m, n), wide)
    np.add.at(ref, cc, _oracle_products(a_data[torch.from_numpy(ai).to(dev)],
                                        b_data[torch.from_numpy(bi).to(dev)], plan.precision))
    scale = max(float(np.max(np.abs(ref))), 1.0)
    err = float(np.max(np.abs(to_host(got).astype(wide) - ref))) / scale
    depth = int(np.diff(run_ptr).max())
    tol = form_tolerance(name_of(c_data.dtype), plan.precision, k, depth)
    if not np.isfinite(err) or err > tol:
        raise KernelValidationError(
            f"{plan.kernel} validation failed for (m={m}, n={n}, k={k}, "
            f"dtype={c_data.dtype}, device={dev}"
            + (f", pack={plan.pack}" if plan.driver == "crosspack" else "")
            + (f", compute={plan.precision}" if plan.precision is not None else "")
            + f"): relative error {err:.3e} > {tol:.1e} vs host oracle")


def process_stack(c_data, a_data, b_data, a_idx, b_idx, c_idx, alpha=1.0,
                  variant: Optional[str] = None, pack=None):
    """Prepare and execute one stack (``c_idx`` sorted ascending), in place
    on ``c_data``; returns it.  ``variant`` and ``pack`` force a kernel as
    in `prepare_stack`; "kmerge" is accepted for parity with the JAX
    package: the TPU's k-merged kernel computes the same function, which
    the base CUDA kernel covers."""
    plan = prepare_stack(c_data, a_data, b_data, a_idx, b_idx, c_idx,
                         variant=variant, pack=pack)
    return execute_stack(c_data, a_data, b_data, plan, alpha)


def transpose_blocks(data: torch.Tensor) -> torch.Tensor:
    """Batched block transpose, (N, m, n) -> (N, n, m), as a new
    contiguous tensor (ref `libsmm_acc_transpose`; the JAX package's
    `transpose_blocks`, `dbcsr_tpu/acc/smm.py:2086`, is `jnp.swapaxes`
    in XLA, not a Pallas kernel)."""
    return data.transpose(1, 2).contiguous()


# ------------------------------------------------------------------ fused
# Superstack execution (ref `dbcsr_tpu/acc/smm.py:1558-1992`): the spans
# of one C bin (one per (A bin, B bin) pair) run as ONE launch, where the
# per-span path pays one launch and one read-modify-write of the bin's C
# blocks per span -- the counterpart of the reference's stack batching
# (`dbcsr_mm_accdrv.F:279-326`).

_DISPATCHES_NAME = "dbcsr_tpu_dispatches_total"
_DISPATCHES_HELP = ("engine dispatches by mode: one per executed span in per_span mode, "
                    "one per fused C-bin launch in fused mode")
_FUSED_SPANS_NAME = "dbcsr_tpu_fused_spans"
_FUSED_SPANS_HELP = "spans carried by each fused launch"
_FUSED_SPANS_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

# the breaker and metrics name of a fused launch: its failures never
# condemn the per-span drivers (which span failed is unknown), they send
# the bin back to the per-span path, where each span's chain applies
FUSED_DRIVER = "fused"


def record_dispatch(mode: str, fused_spans: Optional[int] = None) -> None:
    """Count one dispatch of the engine ("per_span" or "fused") and, for
    a fused launch, the spans it carried."""
    metrics.counter(_DISPATCHES_NAME, _DISPATCHES_HELP).inc(mode=mode)
    if fused_spans is not None:
        metrics.histogram(_FUSED_SPANS_NAME, _FUSED_SPANS_HELP,
                          buckets=_FUSED_SPANS_BUCKETS).observe(fused_spans)


class SuperstackPlan:
    """The fused launch of one C bin: its family ("pallas": K1's fused
    kernel on the card, its plain version on the CPU; "torch": the plain
    spans of CPU tensors, the counterpart of the JAX package's XLA
    family; "host": the native driver's spans on the bin's C in one
    pass), the spans' `StackPlan`s in order, and for "pallas" on the
    card the merged run table (`stack_kernel.superstack_table`).  A
    failover heals span plans in place to another driver; the cache
    (`mm.multiply._CachedSpans.superstack_for`) rebuilds the fused plan
    when the spans' drivers change."""

    __slots__ = ("family", "plans", "table", "nruns")

    def __init__(self, family: str, plans: list, table=None):
        self.family = family
        self.plans = plans
        self.table = table
        # the distinct C blocks the bin's spans write
        self.nruns = (int(table[4].numel()) if table is not None else
                      len(np.unique(np.concatenate([p.run_c.cpu().numpy() for p in plans]))))

    def nbytes(self) -> int:
        """Bytes the merged run table pins (the span plans count apart)."""
        return sum(t.numel() * t.element_size() for t in self.table or ())


def prepare_superstack(plans, shapes, c_data) -> Optional[SuperstackPlan]:
    """The fused plan of one C bin's spans (``plans`` in accumulation
    order, ``shapes`` their (m, n, k), ``c_data`` the bin), or None when
    they cannot fuse: a family holds every span ("pallas": base-kernel
    plans; "torch": plain-version plans of CPU tensors; "host"), native
    real forms only -- a complex or demoted span, a crosspack span or a
    mixed bin keeps the per-span path -- and on the card at most
    `stack_kernel.SUPERSTACK_MAX_SPANS` spans, all on the same path of
    K1 (warp or tiled)."""
    if len(plans) < 2 or any(p is None for p in plans):
        return None
    if c_data.dtype.is_complex or any(p.precision is not None for p in plans):
        return None
    drivers = {p.driver for p in plans}
    if drivers == {"host"}:
        return SuperstackPlan("host", list(plans))
    if drivers == {"torch"}:
        return SuperstackPlan("torch", list(plans)) if c_data.device.type == "cpu" else None
    if drivers != {"kernel"}:
        return None
    if not _on_card(c_data):
        return SuperstackPlan("pallas", list(plans))
    if len(plans) > stack_kernel.SUPERSTACK_MAX_SPANS or len(
            {stack_kernel.kernel_path(m, n, k, c_data.dtype) for m, n, k in shapes}) > 1:
        return None
    table = stack_kernel.superstack_table([p.run_ptr.cpu().numpy() for p in plans],
                                          [p.run_c.cpu().numpy() for p in plans],
                                          c_data.device)
    return SuperstackPlan("pallas", list(plans), table)


def _superstack_key(c_data, nspans: int) -> tuple:
    """The breaker and metrics key of a fused launch: the bin's block
    shape, its span count and dtype."""
    return (c_data.shape[1], c_data.shape[2], nspans, name_of(c_data.dtype))


def _decompose_superstack(c_data, a_datas, b_datas, plans, alpha, c_zero: bool, why: str = ""):
    """Run a fused bin's spans through `execute_stack` instead, each with
    its own guard and failover chain (on the card the chain's kernels,
    never the plain version); ``c_zero`` holds for the first span only."""
    events.publish("superstack_decompose", {"why": why[:200], "spans": len(plans)},
                   flight=("superstack_decompose", {"why": why[:200], "spans": len(plans)}))
    for i, (plan, a_d, b_d) in enumerate(zip(plans, a_datas, b_datas)):
        execute_stack(c_data, a_d, b_d, plan, alpha, c_zero=c_zero and i == 0)
    return c_data


def _dispatch_superstack(c_data, a_datas, b_datas, splan: SuperstackPlan, alpha) -> None:
    """One fused launch, in place on ``c_data`` (the guard lives in
    `execute_superstack`)."""
    if splan.family == "host":
        for plan, a_d, b_d in zip(splan.plans, a_datas, b_datas):
            native.host_smm(c_data, a_d, b_d, *plan.host_idx, alpha)
        return
    spans = [(a_d, b_d, p.a_idx, p.b_idx, p.run_ptr, p.run_c)
             for p, a_d, b_d in zip(splan.plans, a_datas, b_datas)]
    if splan.family == "torch" or splan.table is None:
        stack_kernel.smm_superstack_plain(c_data, spans, alpha,
                                          chunk=get_config().mm_stack_size)
        return
    metrics.record_jit("smm_superstack",
                       (c_data.shape[1], c_data.shape[2], tuple(a.shape[2] for a in a_datas),
                        name_of(c_data.dtype), c_data.device.type))
    stack_kernel.smm_superstack(c_data, spans, splan.table, alpha)


def execute_superstack(c_data, a_datas, b_datas, splan: SuperstackPlan, alpha=1.0,
                       c_zero: bool = False, abft_defer: bool = False):
    """Run every span of one C bin as one fused launch, in place on
    ``c_data``, guarded as `dbcsr_tpu/acc/smm.py:execute_superstack` is:

    * a span whose own breaker is not closed sends the bin per span
      first (a read-only probe, before `allow` of the fused breaker, so
      the fused half-open trial is never taken and left open);
    * an open ``fused`` breaker sends the bin per span;
    * on the card every span's K1 shape is validated on first use before
      the launch (a `KernelValidationError` is counted against the
      span's driver and raised, as `execute_stack` raises it);
    * the ``execute_superstack`` fault site, the finite check and the
      ABFT probe (`abft.check_superstack`, one for the whole bin) run as
      for a stack; a failure is counted against the ``fused`` breaker and
      the bin decomposes from its pristine C (the clone taken first, or
      zeros for a ``c_zero`` bin) into per-span launches
      (`_decompose_superstack`);
    * a demoted probe's breach re-runs the bin per span from the
      pristine C, with no breaker feed.

    Returns ``(c_data, fused)``: ``fused`` is False when the bin ran per
    span."""
    plans = splan.plans
    board = breaker.get_board()
    faults_on = faults.active()
    abft_on = abft.enabled()
    finite_on = _output_checks_enabled()
    bin_key = _superstack_key(c_data, len(plans))
    if board._breakers:
        for plan, a_d, b_d in zip(plans, a_datas, b_datas):
            if board.state(plan.label, _stack_shape_key(c_data, a_d, b_d)) != breaker.CLOSED:
                return _decompose_superstack(c_data, a_datas, b_datas, plans, alpha, c_zero,
                                             why=f"span-breaker:{plan.label}"), False
    if splan.family == "pallas":
        for plan, a_d, b_d in zip(plans, a_datas, b_datas):
            try:
                _ensure_validated(c_data, a_d, b_d, plan)
            except KernelValidationError as exc:
                _record_failure(plan.label, _stack_shape_key(c_data, a_d, b_d), exc, c_data)
                raise  # the oracle ran on its own C: c_data is untouched
    if board._breakers and not board.allow(FUSED_DRIVER, bin_key):
        return _decompose_superstack(c_data, a_datas, b_datas, plans, alpha, c_zero,
                                     why="breaker-open"), False
    base = None
    try:
        # inside the try: a failed clone (out of memory on a large bin)
        # resolves the fused trial as a failure
        if (finite_on or abft_on) and not c_zero:
            base = c_data.clone()
        # counted before the launch: a launch that fails still made its
        # round-trip, and the decompose's per-span dispatches count on top
        record_dispatch("fused", fused_spans=len(plans))
        if faults_on:
            faults.maybe_inject("execute_superstack")
        _dispatch_superstack(c_data, a_datas, b_datas, splan, alpha)
        if faults_on:
            faults.corrupt("execute_superstack", c_data)
        if finite_on and _output_corrupted(c_data):
            raise CorruptedOutputError("fused superstack launch produced non-finite output blocks")
        if abft_on:
            abft.check_superstack(base, c_data, a_datas, b_datas, splan, alpha, c_zero=c_zero,
                                  defer=abft_defer and c_zero, shape_key=bin_key)
    except BuildError:
        raise
    except abft.PrecisionExceededError:
        # a promote, not corruption: per span from the pristine C, where
        # each span's own probe and promote apply
        if base is None and not c_zero:
            raise
        _restore(c_data, base, c_zero)
        return _decompose_superstack(c_data, a_datas, b_datas, plans, alpha, c_zero,
                                     why="precision-promote"), False
    except Exception as exc:  # noqa: BLE001 -- classified, recorded, decomposed
        kind = _classify_failure(exc)
        board.record_failure(FUSED_DRIVER, bin_key, kind=kind)
        _record_driver_failure(FUSED_DRIVER, kind, exc, bin_key)
        # without a check nothing condemns a launch after it wrote: a
        # failure without a clone left C as it was
        if base is not None or c_zero:
            _restore(c_data, base, c_zero)
        _record_fallback(FUSED_DRIVER, "per_span", bin_key)
        _decompose_superstack(c_data, a_datas, b_datas, plans, alpha, c_zero,
                              why=f"{type(exc).__name__}: {exc}")
        if kind == "sdc":
            abft.record_recovery(FUSED_DRIVER)
        return c_data, False
    board.record_success(FUSED_DRIVER, bin_key)
    return c_data, True
