"""Batched small-matrix multiply over parameter stacks.

Counterpart of `dbcsr_tpu/acc/smm.py` (ref `libsmm_acc_process`,
`src/acc/acc_libsmm.h`).  A parameter stack is three index arrays of
length S, sorted by ``c_idx``; entry s means

    C[c_idx[s]] += alpha * A[a_idx[s]] @ B[b_idx[s]]

with A an (Na, m, k) bin, B (Nb, k, n) and C (Nc, m, n).  `prepare_stack`
turns the sorted stack into one run per destination block and uploads
it; `execute_stack` runs it through the stack kernel
(`acc/stack_kernel.py`), in place on C.  The first launch per
(m, n, k, dtype, device) is checked against a float64 host oracle, and a
mismatch raises `KernelValidationError`: nothing demotes to another
driver.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.acc import stack_kernel
from dbcsr_tpu_torch.core.config import get_config
from dbcsr_tpu_torch.core.kinds import name_of
from dbcsr_tpu_torch.core.matrix import to_host
from dbcsr_tpu_torch.obs.costmodel import kernel_validation_tolerance

# (m, n, k, dtype, device type) combinations whose kernel passed
# first-use validation (ref libsmm_acc.cpp:81-85,216)
_validated_kernels: set = set()
_VALIDATE_MAX_ENTRIES = 512


class KernelValidationError(RuntimeError):
    """The stack kernel disagreed with the float64 host oracle."""


class StackPlan:
    """A prepared stack: device index arrays in the kernel's run layout.

    ``driver`` is "kernel" (`stack_kernel.smm_stack`: the CUDA kernel on
    a CUDA tensor, its plain version on a CPU tensor) or "torch" (the
    plain version on any device, ``mm_driver="torch"``)."""

    __slots__ = ("driver", "a_idx", "b_idx", "run_ptr", "run_c", "entries",
                 "nruns", "max_run", "val_idx")

    def __init__(self):
        self.driver = "kernel"
        self.a_idx = self.b_idx = self.run_ptr = self.run_c = None
        self.entries = 0
        self.nruns = 0
        self.max_run = 0
        self.val_idx = None  # host (a, b, c) prefix for first-use validation


def _runs(c_idx: np.ndarray):
    """(run_ptr, run_c) of a stack sorted by destination block."""
    starts = np.concatenate([[0], np.flatnonzero(np.diff(c_idx)) + 1])
    return np.append(starts, len(c_idx)), c_idx[starts]


def _upload(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)


def prepare_stack(c_data, a_data, b_data, a_idx, b_idx, c_idx) -> Optional[StackPlan]:
    """Host side: check the stack, cut it into runs (one per destination
    block) and upload the int32 arrays.  Returns None for an empty stack."""
    cfg = get_config()
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
    run_ptr, run_c = _runs(c_idx)
    dev = c_data.device
    plan = StackPlan()
    plan.driver = "torch" if cfg.mm_driver == "torch" else "kernel"
    plan.a_idx = _upload(a_idx, dev)
    plan.b_idx = _upload(b_idx, dev)
    plan.run_ptr = _upload(run_ptr, dev)
    plan.run_c = _upload(run_c, dev)
    plan.entries = s
    plan.nruns = len(run_c)
    plan.max_run = int(np.diff(run_ptr).max())
    if plan.driver == "kernel" and cfg.validate_kernels:
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
    return stack_kernel.smm_stack(c_data, a_data, b_data, plan.a_idx, plan.b_idx,
                                  plan.run_ptr, plan.run_c, alpha)


def _ensure_validated(c_data, a_data, b_data, plan: StackPlan) -> None:
    if plan.val_idx is None or not get_config().validate_kernels:
        return
    key = (a_data.shape[1], b_data.shape[2], a_data.shape[2],
           name_of(c_data.dtype), c_data.device.type)
    if key in _validated_kernels:
        return
    _validate_kernel(c_data, a_data, b_data, *plan.val_idx)
    _validated_kernels.add(key)


def _validate_kernel(c_data, a_data, b_data, ai, bi, ci) -> None:
    """Run the kernel on a stack prefix into a zeroed, compacted C (one
    block per distinct destination of the prefix) and hold it against a
    float64 host oracle (ref `validate_kernel`, `libsmm_acc.cpp:216`)."""
    m, k = a_data.shape[1:]
    n = b_data.shape[2]
    dest, cc = np.unique(ci, return_inverse=True)
    run_ptr, run_c = _runs(cc)
    dev = c_data.device
    got = torch.zeros((len(dest), m, n), dtype=c_data.dtype, device=dev)
    stack_kernel.smm_stack(got, a_data, b_data, _upload(ai, dev), _upload(bi, dev),
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
            f"stack kernel validation failed for (m={m}, n={n}, k={k}, "
            f"dtype={c_data.dtype}, device={dev}): relative error {err:.3e} "
            f"> {tol:.1e} vs host oracle")


def process_stack(c_data, a_data, b_data, a_idx, b_idx, c_idx, alpha=1.0,
                  variant: Optional[str] = None):
    """Prepare and execute one stack (``c_idx`` sorted ascending), in place
    on ``c_data``; returns it.  ``variant="kmerge"`` is accepted for parity
    with the JAX package: the TPU's k-merged kernel computes the same
    function, which the one CUDA kernel covers."""
    if variant not in (None, "kmerge"):
        raise ValueError(f"unknown stack kernel variant {variant!r}")
    plan = prepare_stack(c_data, a_data, b_data, a_idx, b_idx, c_idx)
    return execute_stack(c_data, a_data, b_data, plan, alpha)
