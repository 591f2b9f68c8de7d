"""Batched small-matrix multiply over parameter stacks.

Counterpart of `dbcsr_tpu/acc/smm.py` (ref `libsmm_acc_process`,
`src/acc/acc_libsmm.h`).  A parameter stack is three index arrays of
length S, sorted by ``c_idx``; entry s means

    C[c_idx[s]] += alpha * A[a_idx[s]] @ B[b_idx[s]]

with A an (Na, m, k) bin, B (Nb, k, n) and C (Nc, m, n).  `prepare_stack`
picks the kernel, turns the sorted stack into its layout and uploads
it; `execute_stack` runs it, in place on C.  Two kernels compute the
function:

* the base stack kernel (`acc/stack_kernel.py`, K1): one run per
  destination block;
* the crosspack kernel (`acc/crosspack_kernel.py`, K3, and its
  operands-resident launch K4): runs dealt into packs of P
  (`acc/crosspack.py`).

The choice follows the JAX package's `_prepare_stack_impl`
(`dbcsr_tpu/acc/smm.py:680-804`) for the drivers the port has: crosspack
when ``mm_driver="pallas_cross"`` forces it, when the tuned table
(`acc/params.py`) says ``crosspack``/``crosspack_vmem``, or under
``"auto"`` for an untuned float32 or bfloat16 stack on the card; float64
stays on the base kernel unless forced or tuned, and a pack of P <= 1
takes the base kernel.  The first launch per (m, n, k, dtype, device)
-- per (m, n, k, dtype, device, variant, pack) for crosspack -- is
checked against a float64 host oracle, and a mismatch raises
`KernelValidationError`: nothing demotes to another driver.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.acc import crosspack_kernel, params, stack_kernel
from dbcsr_tpu_torch.acc.crosspack import choose_pack, prepare_crosspack, runs, supports_resident
from dbcsr_tpu_torch.core.config import get_config
from dbcsr_tpu_torch.core.kinds import name_of
from dbcsr_tpu_torch.core.matrix import to_host
from dbcsr_tpu_torch.obs.costmodel import kernel_validation_tolerance

# kernels that passed first-use validation: (m, n, k, dtype, device type)
# for the base kernel, plus (variant, pack) for crosspack (ref
# libsmm_acc.cpp:81-85,216)
_validated_kernels: set = set()
_VALIDATE_MAX_ENTRIES = 512

_VARIANTS = (None, "kmerge", "crosspack", "crosspack_vmem")
_CROSS_VARIANTS = ("crosspack", "crosspack_vmem")


class KernelValidationError(RuntimeError):
    """A stack kernel disagreed with the float64 host oracle."""


class StackPlan:
    """A prepared stack: device index arrays in the chosen kernel's layout.

    ``driver`` is "kernel" (`stack_kernel.smm_stack`), "torch" (its plain
    version on any device, ``mm_driver="torch"``) or "crosspack"
    (`crosspack_kernel.smm_crosspack`, with ``pack`` = (P, R), the
    ``pack_runs`` layout, and ``resident`` for the launch that keeps the
    operand bin ``window`` in persisting L2).  The kernels run their
    plain versions on a CPU tensor."""

    __slots__ = ("driver", "a_idx", "b_idx", "run_ptr", "run_c", "entries",
                 "nruns", "max_run", "pack", "pack_runs", "pack_longest",
                 "resident", "window", "val_idx")

    def __init__(self):
        self.driver = "kernel"
        self.a_idx = self.b_idx = self.run_ptr = self.run_c = None
        self.entries = 0
        self.nruns = 0
        self.max_run = 0
        self.pack = None          # crosspack: (P, R)
        self.pack_runs = None     # crosspack: int32 (npacks * P,), -1 = empty
        self.pack_longest = None  # crosspack: host, longest run of each pack
        self.resident = False     # crosspack: the K4 launch
        self.window = "a"         # crosspack, resident: the bin kept in L2
        self.val_idx = None  # host (a, b, c) prefix for first-use validation

    @property
    def kernel(self) -> str:
        """The kernel this plan launches on a CUDA tensor."""
        if self.driver == "crosspack":
            return "smm_crosspack_resident" if self.resident else "smm_crosspack"
        return "smm_stack" if self.driver == "kernel" else "plain"


def _upload(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)


def _on_card(c_data) -> bool:
    """Whether the stack lies on the card (the port's reading of the JAX
    package's `_on_tpu` dispatch gate; the CPU tests patch it)."""
    return c_data.device.type == "cuda"


def _crosspack_choice(cfg, c_data, a_data, b_data, s, variant, pack):
    """(pack, resident) when the stack takes the crosspack kernel, else
    None: the rules of `dbcsr_tpu/acc/smm.py:680-771`, without the TPU's
    bf16 guard (:704-717) and without the session demotion
    (`_cross_disabled`)."""
    if variant == "kmerge" or (variant is None and cfg.mm_driver in ("pallas", "torch")):
        return None
    m, k = a_data.shape[1:]
    n = b_data.shape[2]
    tuned = params.predict(m, n, k, c_data.dtype, stack_size=s)
    tuned_cross = bool(tuned) and tuned.get("driver") == "pallas" \
        and tuned.get("variant") in _CROSS_VARIANTS
    if variant is None:
        auto_cross = (cfg.mm_driver == "auto" and tuned is None and _on_card(c_data)
                      and c_data.dtype != torch.float64)
        if not (cfg.mm_driver == "pallas_cross"
                or (cfg.mm_driver == "auto" and tuned_cross) or auto_cross):
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


def prepare_stack(c_data, a_data, b_data, a_idx, b_idx, c_idx,
                  variant: Optional[str] = None, pack=None) -> Optional[StackPlan]:
    """Host side: check the stack, pick the kernel, build its layout and
    upload the int32 arrays.  ``variant`` forces a kernel ("kmerge": the
    base kernel; "crosspack"/"crosspack_vmem": crosspack, the resident
    launch while `supports_resident` holds) and ``pack`` forces (P, R).
    Returns None for an empty stack."""
    cfg = get_config()
    if variant not in _VARIANTS:
        raise ValueError(f"unknown stack kernel variant {variant!r}")
    a_idx = np.asarray(a_idx, np.int64)
    b_idx = np.asarray(b_idx, np.int64)
    c_idx = np.asarray(c_idx, np.int64)
    s = len(a_idx)
    if s == 0:
        return None
    if len(b_idx) != s or len(c_idx) != s:
        raise ValueError("a_idx/b_idx/c_idx lengths differ")
    if s >= 2 ** 31:
        raise ValueError(f"stack of {s} entries exceeds the int32 index range")
    if np.any(np.diff(c_idx) < 0):
        raise ValueError("stack must be sorted by c_idx")
    for name, idx, bound in (("a_idx", a_idx, a_data.shape[0]),
                             ("b_idx", b_idx, b_data.shape[0]),
                             ("c_idx", c_idx, c_data.shape[0])):
        if idx.min() < 0 or idx.max() >= bound:
            raise IndexError(f"{name} out of range [0, {bound})")
    dev = c_data.device
    plan = StackPlan()
    choice = _crosspack_choice(cfg, c_data, a_data, b_data, s, variant, pack)
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
        plan.driver = "torch" if variant is None and cfg.mm_driver == "torch" else "kernel"
        run_ptr, run_c = runs(c_idx)
    plan.a_idx = _upload(a_idx, dev)
    plan.b_idx = _upload(b_idx, dev)
    plan.run_ptr = _upload(run_ptr, dev)
    plan.run_c = _upload(run_c, dev)
    plan.entries = s
    plan.nruns = len(run_c)
    plan.max_run = int(np.diff(run_ptr).max())
    if plan.driver != "torch" and cfg.validate_kernels:
        p = min(s, _VALIDATE_MAX_ENTRIES)
        plan.val_idx = (a_idx[:p], b_idx[:p], c_idx[:p])
    return plan


def execute_stack(c_data, a_data, b_data, plan: Optional[StackPlan], alpha=1.0):
    """Device side: run a prepared plan on (possibly new) data, updating
    ``c_data`` in place; returns it."""
    if plan is None:
        return c_data
    if plan.driver == "torch":
        return stack_kernel.smm_stack_plain(
            c_data, a_data, b_data, plan.a_idx, plan.b_idx, plan.run_ptr,
            plan.run_c, alpha, chunk=get_config().mm_stack_size)
    _ensure_validated(c_data, a_data, b_data, plan)
    if plan.driver == "crosspack":
        return crosspack_kernel.smm_crosspack(
            c_data, a_data, b_data, plan.a_idx, plan.b_idx, plan.run_ptr,
            plan.run_c, plan.pack_runs, plan.pack, alpha,
            resident=plan.resident, window=plan.window)
    return stack_kernel.smm_stack(c_data, a_data, b_data, plan.a_idx, plan.b_idx,
                                  plan.run_ptr, plan.run_c, alpha)


def _ensure_validated(c_data, a_data, b_data, plan: StackPlan) -> None:
    if plan.val_idx is None or not get_config().validate_kernels:
        return
    key = (a_data.shape[1], b_data.shape[2], a_data.shape[2],
           name_of(c_data.dtype), c_data.device.type)
    if plan.driver == "crosspack":
        key += ("crosspack_vmem" if plan.resident else "crosspack", plan.pack)
    if key in _validated_kernels:
        return
    _validate_kernel(c_data, a_data, b_data, plan, *plan.val_idx)
    _validated_kernels.add(key)


def _validate_kernel(c_data, a_data, b_data, plan: StackPlan, ai, bi, ci) -> None:
    """Run the plan's kernel on a stack prefix into a zeroed, compacted C
    (one block per distinct destination of the prefix) and hold it
    against a float64 host oracle (ref `validate_kernel`,
    `libsmm_acc.cpp:216`)."""
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
                               _upload(run_ptr, dev), _upload(run_c, dev), 1.0)
    a_h = to_host(a_data[torch.from_numpy(ai).to(dev)]).astype(np.float64)
    b_h = to_host(b_data[torch.from_numpy(bi).to(dev)]).astype(np.float64)
    ref = np.zeros((len(dest), m, n), np.float64)
    np.add.at(ref, cc, np.einsum("smk,skn->smn", a_h, b_h))
    scale = max(float(np.max(np.abs(ref))), 1.0)
    err = float(np.max(np.abs(to_host(got).astype(np.float64) - ref))) / scale
    depth = int(np.diff(run_ptr).max())
    tol = kernel_validation_tolerance(name_of(c_data.dtype), k, depth)
    if not np.isfinite(err) or err > tol:
        raise KernelValidationError(
            f"{plan.kernel} validation failed for (m={m}, n={n}, k={k}, "
            f"dtype={c_data.dtype}, device={dev}"
            + (f", pack={plan.pack}" if plan.driver == "crosspack" else "")
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
