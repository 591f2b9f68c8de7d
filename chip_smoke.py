#!/usr/bin/env python3
"""On-card smoke test of dbcsr_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``dbcsr_tpu_torch/csrc`` with
nvcc (both sources at once) and the multiply's host index engine from
``dbcsr_tpu_torch/native`` with g++, then runs these phases, each
printing one JSON line; any failure raises and the script exits
non-zero:

1. build: the card's name and power limit, CUDA version, nvcc seconds
   and ptxas resource lines of each source, the persisting-L2 limit,
   and the index engine's g++ flags and seconds;
2. kernel_vs_plain: the base stack kernel (K1) against its plain PyTorch
   version, f64/f32/bf16 at block shapes (23,23,23), (23,18,23),
   (18,23,18), (5,13,23), the warp path's edges (32,32,32), (33,24,23)
   and (8,8,4), and (100,50,20), on stacks with short runs, one run of
   5000 entries, alpha != 1 and a nonzero incoming C; each case names
   the path it took (warp or tiled), and both paths must run;
3. crosspack_vs_plain: the crosspack kernel (K3) and its resident launch
   (K4) against their plain version on the same kind of stacks, at
   `choose_pack`'s pack for the same seven shapes and a forced pack
   (3, 5) for (16,24,12), both paths again; (100,50,20) must plan onto
   K1 (P = 1);
4. perf_gates: the `.perf` checksum gates through `run_perf` under
   ``mm_driver="auto"`` on the stack format (f64: K1 must launch, no
   plain version);
5. perf_gates_crosspack: the same gates under ``mm_driver="pallas_cross"``
   (K3 must launch, except on the 100/50/20 blocks, which take K1);
6. northstar: the north-star product (10k x 10k, 23x23 blocks,
   occupancy 0.1, f64, beta 0, 3 repeats) through K1, held against one
   repeat with ``mm_driver="torch"`` (the plain version) at rel <= 1e-10;
   repeats 2-3 must hit the multiply's plan cache, and the host "plan"
   seconds of the first repeat and of the hits are printed;
7. native_index: on the north star's operands, the native engine's
   expansion and stack sort against the NumPy path and `np.lexsort`
   (identical arrays and order), each piece of "index" and "plan" timed,
   then the multiply's host phases, plan-cache miss and hit, under both
   engines in turns (numpy, native, native, numpy), C bit for bit the
   same, and "index" on 10 pairs of plan-cache hits in turns;
   northstar_stacks: K1 and its plain version compared and timed on the
   north star's own stacks, with the least time the card could take
   (every stack of the ``*_stacks`` phases must take the warp path);
8. northstar_f32: the north star as sreal through K3 (no K1 launch, no
   plain call), held against one ``"torch"`` repeat (elementwise at the
   kernel validation tolerance, checksums at rel <= 1e-6), then K3 and
   its plain version timed on its stacks, and the host planning of its
   stacks for K1 and for K3 timed in turns;
9. resident_f32: `test_H2O` as sreal with a tuned ``crosspack_vmem`` row
   in a temporary parameter directory, through K4, held against the
   ``"torch"`` driver likewise, then K4, K3 and the plain version timed
   on its stacks;
10. formats: at the models' size (2208^2, 96 block rows of 23, full
   operands, f64 and f32) ``mm_format`` forced to "stack", "dense" and
   "composite" and left at "auto", and on a banded pattern with
   independent row panels the same four; every leg against the stack
   leg (f64 1e-12, f32 the kernel validation tolerance); the canvas
   GEMM timed alone beside its bound; the north star forced dense
   (`_dense_multiply_general`) beside its stack time and result; the
   `.perf` gates under the planner ("auto");
11. limits: block limits and unaligned element limits with beta 0.7 at
   2208^2 under ``"auto"`` (K1) and ``"torch"``, against each other at
   1e-12 and against a dense windowed oracle on the card; C outside the
   window bit for bit as it was;
12. models: the three linear-scaling DFT loops at `test_H2O`'s blocking
   (96 block rows of 23, 2208^2, f64) on `make_test_density(96, 23)`:
   McWeeny purification of the density, the filtered Newton-Schulz sign
   iteration of the density shifted by -0.5 on its diagonal, and the
   inverse square root of the density shifted by +0.5.  Each runs under
   ``"auto"`` (the planner: the sign loop must launch K1, purify and
   invsqrt must take the dense format; no plain call) and under
   ``"torch"`` on the stack format;
   histories and final iterates must agree (1e-10, or 10 * filter_eps
   where filtered), invsqrt must reach its tol, and purify's and sign's
   convergence measures must fall.  Each run prints its multiplies,
   launches, plan-cache outcomes, host seconds per phase, the stacks'
   device seconds (CUDA events), its format decisions, its wall time,
   the matrices its chains freed and the caching allocator's peak bytes;
   then in turns: the sign loop under the NumPy index path and the
   engine, purify and invsqrt under the planner and on the stack format;
13. models_f32: the sign iteration as f32 on the stack format through
   K3, held against ``"torch"`` elementwise at the kernel validation
   tolerance.
14. tensor_legs: the RI step of the water system below at cut depths
   (`TENSOR_LEGS`): at 32 molecules a contraction into the mapping
   (mu | nu,Q), then `tensor_copy` and `remap` back to (mu,nu | Q), bit
   for bit the direct contraction; at 48 a batched contraction over 4
   mu batches with ``filter_eps`` 1e-10 against one contraction
   (<= 1e-12); at 48 as f32 through the kernel "auto" picks (its line
   names it and its path) against ``"torch"`` at the kernel validation
   tolerance; at 12 `contract_test` against a dense einsum on the host;
15. tensor: (mu nu|P) M(P,Q) -> (mu nu|Q) at full width through
   `tensor.contract` on `test_H2O`'s blocking: 96 molecules of 23
   orbitals, T where the density's pair pattern has (mu,nu) and (mu,P)
   (43,526 blocks of 23^3, 4.24 GB, seeded normals drawn on the card), M
   the density, C 190,965 blocks (18.6 GB); the TAS split (64 groups of
   block limits) runs K1's tiled path on (529,23,23) products.  It
   prints nsplit, the wall time, the host phases, the stacks' device
   time beside their bound, the plan-cache outcomes, the allocator's
   peak and retries, and holds every block of C against the plain
   driver (run in two mu batches with ``bounds_2``) at <= 1e-10, the
   checksums at <= 1e-12;
16. resilience: faults injected on the card at `test_H2O`'s blocking
   (2208^2), each counted exactly, and no faulted product on the card
   ever runs a plain version (the card's chain holds the kernels only):
   ``pallas:raise,times=1`` (K1 fails over to the crosspack kernel K3,
   within 1e-12 of the clean product, one ``runtime`` failure and one
   fallback), ``execute_stack:nan,times=1`` (classified ``nan`` and
   recovered on K3), ``pallas:raise`` three times (the shape's breaker
   opens; the next product launches no K1 and runs on K3), ``dense:raise,times=1``
   on full operands (the canvas falls over to the stack format within
   1e-12), ``pallas_cross:raise`` and ``pallas_cross:oom`` on f32 (K3 fails
   over to K1; a runtime failure demotes the shape, so the next product
   plans onto K1, an out-of-memory one does not); ``mm_driver="host"`` on
   CPU matrices against ``"torch"`` (1e-12, both timed) and refused on the
   card's tensors; and `test_H2O.perf`'s checksum gate under a failing
   K1 launch;
17. integrity: on the models' operands (f64, 2208^2) the three loops
   under ``abft="verify"`` and ``"off"`` in turns, histories and iterates
   bit for bit alike, no mismatch and no rollback; each loop with ABFT
   off under a flip its chain invariant catches in the same step
   (`INVARIANT_FLIPS`: it rolls back, bit for bit on the clean loop) and
   under ``execute_stack:flip,seed=13,times=1`` (`FLIP`: each loop must
   end as the JAX package's guarded loop ends at this size,
   `FLIP_OFF_REFERENCE`), and under `FLIP` with "verify" (the probe
   recovers, nothing rolls back, bit for bit); purify under
   ``dense:flip,times=1`` (the canvas probe condemns the product, the
   stack format redoes it, within 1e-12); the north star, f64 (K1) and
   f32 (K3), under "verify" against "off" in turns, C bit for bit, with
   the probe's milliseconds beside the stacks'.
18. complex (before resilience): the north star's pattern at complex128
   and complex64 through `run_perf` on K1's complex form (the tiled
   path; no crosspack, no plain call), against ``"torch"`` (1e-10 at
   complex128, the kernel validation tolerance at complex64), its
   stacks timed beside their bound; and C = alpha A B^H at 2208^2
   (``transb="C"``) against the plain driver and a dense oracle;
19. precision (before resilience): every demoted form of K1 against its
   plain version on both paths (runs up to 5000 entries) within the
   rounding of the form's sums (`form_tolerance`; every ``*_stacks``
   phase holds each span so); the f64 north star under ``precision="adaptive"``
   and ``abft="verify"`` (every stack demoted, every probe passing, C
   within the ceiling of native, seconds per multiply native and
   demoted in turns); the forced modes "f32" and "bf16" and a tuned
   ``precision`` column on `test_H2O` (each form's launches and stacks);
   a forced promote (ceiling sabotaged; beta 0 and 0.5): a native
   re-execution bit for bit the native product, the cell native after;
   the sign loop under adaptive + verify demoting, promoting once and
   ending below the iteration's tolerance as the native loop does;
20. incremental (after integrity): the f32 north star on K3 and a
   2208^2 f64 product on K1, each repeated until the result cache
   installs, then a zero delta, one block row of A and 0.1%, 1% and 5%
   of A's blocks: every reuse bit for bit an ``incremental="full"`` run,
   its outcome counted (a splice, or a full recompute where a splice
   as large lost), each case timed against "full" in turns with its host phases;
   at 2208^2 the full-product probe under "verify", and an
   ``incremental:flip`` caught, counted and recomputed; the f64 north
   star never cached (its C is over the 512 MB budget); the three DFT
   loops under the default "auto" against "off" in turns, bit for bit.

The phases before `incremental` run with ``incremental="off"``, as the
perf driver's repeats do: they time the engine.  Every phase but
resilience, integrity and incremental injects nothing and must end with
no driver failure, fallback, ABFT mismatch or rollback (`_clean`); those
three clear their faults and reset the breakers whatever happens.

The line before the last is the kernels' JSON summary (K1's entry lists
its complex and demoted ``forms``, each with its launches on its
phase's main path, time, error and bound); the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 2 and prints
no result.
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dbcsr_tpu_torch import native
from dbcsr_tpu_torch.acc import abft, build, crosspack_kernel, params, stack_kernel
from dbcsr_tpu_torch.acc import precision as port_precision
from dbcsr_tpu_torch.acc import smm as port_smm
from dbcsr_tpu_torch.acc.crosspack import choose_pack, resident_limit_bytes
from dbcsr_tpu_torch.acc.smm import prepare_stack
from dbcsr_tpu_torch.core import mempool, timings
from dbcsr_tpu_torch.core.config import set_config
from dbcsr_tpu_torch.core.kinds import dtype_of, name_of
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.device import resolve_device
from dbcsr_tpu_torch.mm import incremental as port_inc
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.mm.multiply import (
    _build_spans,
    _candidates,
    _candidates_numpy,
    _effective,
    _to_dense_device,
)
from dbcsr_tpu_torch.models import integrity
from dbcsr_tpu_torch.models import (
    invsqrt_iteration,
    make_test_density,
    mcweeny_purify,
    sign_iteration,
)
from dbcsr_tpu_torch.ops.operations import (
    add_on_diag,
    added,
    copy,
    frobenius_norm,
    gershgorin_norm,
    maxabs_norm,
    scale,
    trace,
)
from dbcsr_tpu_torch.ops.test_methods import make_random_matrix
from dbcsr_tpu_torch.obs import costmodel as port_costmodel
from dbcsr_tpu_torch.obs import events, metrics
from dbcsr_tpu_torch.obs.costmodel import (
    crosspack_entries,
    demoted_abft_tolerance,
    form_tolerance,
    kernel_validation_tolerance,
    H100_BYTES_PER_S,
    H100_PEAK_FLOPS,
    stack_bound_s,
    stack_bytes,
    stack_min_bytes,
)
from dbcsr_tpu_torch.perf.driver import expand_block_sizes, parse_perf_file, run_perf
from dbcsr_tpu_torch.resilience import breaker, faults
from dbcsr_tpu_torch.tensor import (
    batched_contraction,
    contract,
    contract_test,
    copy_matrix_to_tensor,
    create_tensor,
    remap,
    tensor_copy,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(ROOT, "tests", "inputs")

KERNELS = {
    "smm_stack": ("dbcsr_tpu_torch/csrc/smm_stack.cu",
                  "dbcsr_tpu/acc/pallas_smm.py:132"),
    "smm_crosspack": ("dbcsr_tpu_torch/csrc/smm_crosspack.cu",
                      "dbcsr_tpu/acc/pallas_smm.py:456"),
    "smm_crosspack_resident": ("dbcsr_tpu_torch/csrc/smm_crosspack.cu",
                               "dbcsr_tpu/acc/pallas_smm.py:535"),
}
LIBRARY_NOTE = "no single PyTorch call computes this function"


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _reset_counts() -> None:
    stack_kernel.reset_counts()
    crosspack_kernel.reset_counts()


def _counts() -> dict:
    return {"smm_stack": stack_kernel.launches,
            "smm_crosspack": crosspack_kernel.launches_cross,
            "smm_crosspack_resident": crosspack_kernel.launches_resident,
            "plain": stack_kernel.plain_calls + crosspack_kernel.plain_calls}


def _calls(plan, resident=None):
    """(kernel, plain) callables running ``plan``'s kernel and its plain
    version as ``f(c, a, b, alpha)`` (at the plan's precision);
    ``resident`` overrides a crosspack plan's launch."""
    if plan.driver != "crosspack":
        args = (plan.a_idx, plan.b_idx, plan.run_ptr, plan.run_c)
        prec = plan.precision
        return (lambda c, a, b, al: stack_kernel.smm_stack(c, a, b, *args, al, precision=prec),
                lambda c, a, b, al: stack_kernel.smm_stack_plain(c, a, b, *args, al,
                                                                 precision=prec))
    args = (plan.a_idx, plan.b_idx, plan.run_ptr, plan.run_c, plan.pack_runs, plan.pack)
    res = plan.resident if resident is None else resident
    return (lambda c, a, b, al: crosspack_kernel.smm_crosspack(
                c, a, b, *args, al, resident=res, window=plan.window),
            lambda c, a, b, al: crosspack_kernel.smm_crosspack_plain(c, a, b, *args, al))


def _written(kernel, c, a, b, alpha):
    """``kernel`` on a copy of ``c``, which it must mark as written (its
    version counter moves, as `mm.multiply._dense_canvas_cached` needs)."""
    out = c.clone()
    version = out._version
    kernel(out, a, b, alpha)
    _require(out._version > version, "a kernel wrapper wrote C without bumping its version")
    return out


def _wide(t):
    """``t`` in float64, or complex128 for a complex tensor."""
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def _rel_err(got, want) -> float:
    diff = float((_wide(got) - _wide(want)).abs().max())
    return diff / max(float(_wide(want).abs().max()), 1.0)


def phase_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    build.build_all()
    native.get_lib()
    _emit({"phase": "build", "card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0),
           "nvcc_s": {src: build.build_seconds[src] for src in build.SOURCES},
           "ptxas": {src: [ln.strip() for ln in build.build_logs.get(src, "").splitlines()
                           if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
                     for src in build.SOURCES},
           "persisting_l2_bytes": resident_limit_bytes(resolve_device()),
           "index_engine": {"compiler": "g++", "flags": list(native.FLAGS),
                            "seconds": native.build_seconds,
                            "library": os.path.basename(native.library_path())}})
    return card


def _synthetic_stack(rng, m, n, k, dtype, long_run=5000):
    """Operand bins and a sorted stack: 300 C blocks with runs of 1-4
    entries, plus one C block with a run of ``long_run`` entries."""
    na, nb, nc = 700, 600, 301
    dev = resolve_device()
    a = torch.from_numpy(rng.standard_normal((na, m, k))).to(dev, dtype)
    b = torch.from_numpy(rng.standard_normal((nb, k, n))).to(dev, dtype)
    c = torch.from_numpy(rng.standard_normal((nc, m, n))).to(dev, dtype)
    lens = rng.integers(1, 5, size=nc)
    lens[150] = long_run
    c_idx = np.repeat(np.arange(nc), lens)
    a_idx = rng.integers(0, na, size=len(c_idx))
    b_idx = rng.integers(0, nb, size=len(c_idx))
    return a, b, c, a_idx, b_idx, c_idx


# block shapes of the kernel-vs-plain phases: the north star's, shapes of
# the `.perf` inputs, and the warp path's edges: (32,32,32) at its limit,
# (33,24,23) just above it, (8,8,4) with no padding
SHAPES = ((23, 23, 23), (23, 18, 23), (18, 23, 18), (5, 13, 23), (32, 32, 32),
          (33, 24, 23), (8, 8, 4))


def phase_kernel_vs_plain() -> None:
    rng = np.random.default_rng(20261016)
    alpha = -0.75
    cases = []
    paths = set()
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for m, n, k in SHAPES + ((100, 50, 20),):
            a, b, c, a_idx, b_idx, c_idx = _synthetic_stack(rng, m, n, k, dtype)
            plan = prepare_stack(c, a, b, a_idx, b_idx, c_idx, variant="kmerge")
            kernel, plain = _calls(plan)
            path = stack_kernel.kernel_path(m, n, k)
            paths.add(path)
            got = _written(kernel, c, a, b, alpha)
            want = plain(c.clone(), a, b, alpha)
            torch.cuda.synchronize()
            rel = _rel_err(got, want)
            tol = kernel_validation_tolerance(name_of(dtype), k, plan.max_run)
            _require(np.isfinite(rel) and rel <= tol,
                     f"kernel != plain for {dtype} {(m, n, k)} ({path} path): "
                     f"rel {rel:.3e} > {tol:.1e}")
            scratch = c.clone()
            ms = _time_ms(lambda: kernel(scratch, a, b, alpha), 10)
            plain_ms = _time_ms(lambda: plain(scratch, a, b, alpha), 3)
            bound, by = stack_bound_s(name_of(dtype), m, n, k, plan.entries,
                                      len(np.unique(a_idx)), len(np.unique(b_idx)), plan.nruns)
            cases.append({"dtype": name_of(dtype), "mnk": [m, n, k], "path": path,
                          "entries": plan.entries, "runs": plan.nruns,
                          "longest_run": plan.max_run, "max_rel_err": rel,
                          "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound * 1e3, "bound_by": by})
    _require(paths == {"warp", "tiled"}, f"K1 ran the paths {sorted(paths)}, not both")
    _emit({"phase": "kernel_vs_plain", "alpha": alpha, "library_ms": None,
           "library_note": LIBRARY_NOTE, "cases": cases})


def phase_crosspack_vs_plain() -> None:
    rng = np.random.default_rng(20261017)
    alpha = -0.75
    cases = []
    paths = set()
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for (m, n, k), pack in [(mnk, None) for mnk in SHAPES] + [((16, 24, 12), (3, 5))]:
            a, b, c, a_idx, b_idx, c_idx = _synthetic_stack(rng, m, n, k, dtype)
            plan = prepare_stack(c, a, b, a_idx, b_idx, c_idx, variant="crosspack",
                                 pack=pack)
            _require(plan.driver == "crosspack" and plan.pack == (pack or choose_pack(m, n, k)),
                     f"{(m, n, k)} did not plan onto crosspack at its pack")
            tol = kernel_validation_tolerance(name_of(dtype), k, plan.max_run)
            bound, by = stack_bound_s(name_of(dtype), m, n, k, plan.entries,
                                      len(np.unique(a_idx)), len(np.unique(b_idx)), plan.nruns)
            path = crosspack_kernel.kernel_path(dtype, plan.pack, m, n, k)
            paths.add(path)
            row = {"dtype": name_of(dtype), "mnk": [m, n, k], "pack": list(plan.pack),
                   "path": path,
                   "entries": plan.entries, "runs": plan.nruns, "packs": plan.pack_runs.numel()
                   // plan.pack[0], "entry_slots": crosspack_entries(plan),
                   "longest_run": plan.max_run, "tolerance": tol,
                   "bound_ms": bound * 1e3, "bound_by": by, "library_ms": None}
            _, plain = _calls(plan)
            want = plain(c.clone(), a, b, alpha)
            scratch = c.clone()
            row["plain_ms"] = _time_ms(lambda: plain(scratch, a, b, alpha), 3)
            for tag, resident in (("cross", False), ("resident", True)):
                kernel, _ = _calls(plan, resident=resident)
                got = _written(kernel, c, a, b, alpha)
                torch.cuda.synchronize()
                rel = _rel_err(got, want)
                _require(np.isfinite(rel) and rel <= tol,
                         f"crosspack ({tag}) != plain for {dtype} {(m, n, k)} pack "
                         f"{plan.pack} ({path} path): rel {rel:.3e} > {tol:.1e}")
                row[f"{tag}_max_rel_err"] = rel
                row[f"{tag}_ms"] = _time_ms(lambda: kernel(scratch, a, b, alpha), 10)
            cases.append(row)
    # blocks too wide to pack side by side plan onto the base kernel
    a, b, c, a_idx, b_idx, c_idx = _synthetic_stack(rng, 100, 50, 20, torch.float32, 10)
    plan = prepare_stack(c, a, b, a_idx, b_idx, c_idx, variant="crosspack")
    _require(plan.driver == "kernel" and choose_pack(100, 50, 20)[0] == 1,
             f"(100, 50, 20) planned onto {plan.driver}, not the base kernel")
    _require(paths == {"warp", "tiled"}, f"K3 ran the paths {sorted(paths)}, not both")
    _emit({"phase": "crosspack_vs_plain", "alpha": alpha, "library_ms": None,
           "library_note": LIBRARY_NOTE, "p1_shape_takes_base_kernel": [100, 50, 20],
           "cases": cases})


PERF_GATES = (("test_H2O", 3), ("test_square_sparse", 1), ("test_rect1_sparse", 1),
              ("test_rect2_sparse", 1), ("test_singleblock", 1),
              ("test_square_sparse_bigblocks", 1))


def phase_perf_gates(driver: str) -> None:
    """The `.perf` gates under ``mm_driver=driver``: "auto" (f64 takes
    K1) or "pallas_cross" (K3, except where P = 1)."""
    rows = []
    set_config(mm_driver=driver, mm_format="stack")
    try:
        for name, nrep in PERF_GATES:
            cfg = parse_perf_file(os.path.join(INPUTS, f"{name}.perf"))
            cfg.nrep = nrep
            _reset_counts()
            res = run_perf(cfg, verbose=False)  # raises PerfChecksumError on mismatch
            counts = _counts()
            wanted = "smm_crosspack" if driver == "pallas_cross" else "smm_stack"
            if driver == "pallas_cross" and all(
                    choose_pack(m, n, k)[0] == 1 for m, n, k, *_ in res["spans"]):
                wanted = "smm_stack"  # every span has P = 1
            _require(counts[wanted] > 0, f"{name} under {driver}: {wanted} never launched")
            _require(counts["plain"] == 0,
                     f"{name} under {driver}: the plain versions ran {counts['plain']} times")
            rows.append({"input": name, "nrep": nrep, "checksum": res["checksum"],
                         "checksum_pos": res["checksum_pos"],
                         "refs": list(cfg.check_refs), "threshold": cfg.check_threshold,
                         "launches": counts, "kernels": sorted({s[4] for s in res["spans"]}),
                         "times_s": res["times_s"], "gflops_best": res["gflops_best"]})
    finally:
        set_config(mm_driver="auto", mm_format="auto")
    _emit({"phase": "perf_gates" if driver == "auto" else "perf_gates_crosspack",
           "mm_driver": driver, "mm_format": "stack", "passed": len(rows), "inputs": rows})


def _northstar_cfg(nrep: int, data_type: int = 3):
    cfg = parse_perf_file(os.path.join(INPUTS, "northstar.perf"))
    cfg.beta = 0.0  # as bench.py runs it
    cfg.nrep = nrep
    cfg.data_type = data_type
    return cfg


def _against_torch_driver(res, cfg, tol_el: float, tol_cs: float) -> dict:
    """One repeat of ``cfg`` under ``mm_driver="torch"`` (the plain
    version): C's pattern must be equal, the elementwise error relative
    to max |C| within ``tol_el`` and both checksums within ``tol_cs``."""
    cfg.nrep = 1
    set_config(mm_driver="torch")
    try:
        ref = run_perf(cfg, verbose=False)
    finally:
        set_config(mm_driver="auto")
    c_out, c_ref = res["matrices"]["c_out"], ref["matrices"]["c_out"]
    _require(np.array_equal(c_out.keys, c_ref.keys), "C patterns differ from the torch driver's")
    rel_cs = abs(res["checksum"] - ref["checksum"]) / abs(ref["checksum"])
    rel_pos = abs(res["checksum_pos"] - ref["checksum_pos"]) / abs(ref["checksum_pos"])
    scale = max(float(b.data.abs().max()) for b in c_ref.bins if b.count)
    rel_el = max(float((_wide(x.data) - _wide(y.data)).abs().max())
                 for x, y in zip(c_out.bins, c_ref.bins) if x.count) / scale
    _require(rel_cs <= tol_cs and rel_pos <= tol_cs and rel_el <= tol_el,
             f"kernel vs torch driver rel {rel_cs:.3e}/{rel_pos:.3e}/{rel_el:.3e} "
             f"> {tol_cs:.1e}/{tol_cs:.1e}/{tol_el:.1e}")
    return {"torch_driver_checksum": ref["checksum"],
            "torch_driver_checksum_pos": ref["checksum_pos"],
            "torch_driver_times_s": ref["times_s"],
            "rel_checksum": rel_cs, "rel_checksum_pos": rel_pos,
            "rel_elementwise": rel_el, "tolerance_elementwise": tol_el,
            "tolerance_checksum": tol_cs}


def _run_summary(res, nrep: int, counts: dict) -> dict:
    return {"nrep": nrep, "times_s": res["times_s"], "host_s": res["host_s"],
            "host_phase_s": res["host_phase_s"], "device_s": res["device_s"],
            "algorithms": res["algorithms"],
            "flops": res["flops"],
            "gflops_true": [res["flops"] / t / 1e9 for t in res["times_s"]],
            "launches": counts,
            "launches_per_multiply": {k: v / nrep for k, v in counts.items()},
            "spans": res["spans"], "checksum": res["checksum"],
            "checksum_pos": res["checksum_pos"],
            "c_blocks": int(res["matrices"]["c_out"].nblks)}


def phase_northstar() -> dict:
    _reset_counts()
    res = run_perf(_northstar_cfg(3), verbose=False)
    counts = _counts()
    _require(counts["smm_stack"] > 0, "north star: the stack kernel never launched")
    _require(counts["plain"] == 0, f"north star: the plain versions ran {counts['plain']} times")
    _require(res["plan_cache"][1:] == ["hit", "hit"],
             f"north star: repeats 2-3 did not hit the plan cache: {res['plan_cache']}")
    _require(res["algorithms"] == ["stack"] * 3,
             f"north star: the planner chose {res['algorithms']}, not the stack format")
    out = {"phase": "northstar", "shape": [10000, 10000, 10000], "block": 23,
           "occupancy": 0.1, "dtype": "float64", **_run_summary(res, 3, counts),
           "plan_cache": res["plan_cache"],
           "plan_s_first": res["host_phase_s"][0]["plan"],
           "plan_s_hits": [p["plan"] for p in res["host_phase_s"][1:]]}
    out.update(_against_torch_driver(res, _northstar_cfg(1), 1e-10, 1e-10))
    _emit(out)
    return {"launches": counts["smm_stack"], "a": res["matrices"]["a"],
            "b": res["matrices"]["b"], "c": res["matrices"]["c_out"]}


def _stacks_phase(phase: str, a, b, c, kernels=(None,), reps=5, path="warp") -> dict:
    """Each stack of the product ``c = a * b``, re-planned from its
    operands under the config in force (every one must take its kernel's
    ``path``), run through
    its plan's kernel (``kernels``: None for the
    plan's own launch, False/True to force a crosspack plan's plain or
    resident launch) and its plain version: compared (within the form's
    `form_tolerance` at the stack's k and longest run), and timed by CUDA
    events (kernel mean of ``reps`` launches, plain mean of 2); times
    summed per multiply, beside the least time the card could take."""
    t0 = time.perf_counter()
    i, j, a_ent, b_ent = _candidates(a, b, None)
    keys = i * c.nblkcols + j
    t1 = time.perf_counter()
    spans = _build_spans(c, a, b, keys, a_ent, b_ent)
    host_s = {"index": t1 - t0, "plan": time.perf_counter() - t1}
    alpha = 1.0
    rows = []
    tot = {"ms": [0.0] * len(kernels), "plain_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": [0.0] * len(kernels)}
    modeled_bytes = min_bytes = 0
    for sp in spans:
        ad, bd, cd = a.bins[sp.abin].data, b.bins[sp.bbin].data, c.bins[sp.cbin].data
        plan = sp.plan
        _, plain = _calls(plan)
        want = plain(cd.clone(), ad, bd, alpha)
        scratch = cd.clone()
        kpath = (crosspack_kernel.kernel_path(cd.dtype, plan.pack, sp.m, sp.n, sp.k)
                 if plan.driver == "crosspack"
                 else stack_kernel.kernel_path(sp.m, sp.n, sp.k, cd.dtype))
        _require(kpath == path, f"{phase}: the {(sp.m, sp.n, sp.k)} span took the {kpath} path")
        row = {"mnk": [sp.m, sp.n, sp.k], "entries": sp.entries, "runs": plan.nruns,
               "kernel": sp.driver, "path": kpath, "ms": [], "max_abs_err": [],
               "form": stack_kernel.form_name(cd.dtype, plan.precision)}
        if plan.driver == "crosspack":
            row["pack"] = list(plan.pack)
            row["entry_slots"] = crosspack_entries(plan)
        tol = form_tolerance(name_of(cd.dtype), plan.precision, sp.k, plan.max_run)
        row["tolerance"] = tol
        for ki, resident in enumerate(kernels):
            kernel, _ = _calls(plan, resident=resident)
            got = kernel(cd.clone(), ad, bd, alpha)
            err = float((_wide(got) - _wide(want)).abs().max())
            rel = _rel_err(got, want)
            _require(np.isfinite(rel) and rel <= tol,
                     f"{phase}: {row['form']} {(sp.m, sp.n, sp.k)} ({kpath} path) against its "
                     f"plain version: rel {rel:.3e} > {tol:.1e}")
            row.setdefault("max_rel_err", []).append(rel)
            del got
            ms = _time_ms(lambda: kernel(scratch, ad, bd, alpha), reps)
            row["ms"].append(ms)
            row["max_abs_err"].append(err)
            tot["ms"][ki] += ms
            tot["max_abs_err"][ki] = max(tot["max_abs_err"][ki], err)
        row["plain_ms"] = _time_ms(lambda: plain(scratch, ad, bd, alpha), 2)
        del scratch, want
        counts = (name_of(cd.dtype), sp.m, sp.n, sp.k, sp.entries,
                  len(torch.unique(plan.a_idx)), len(torch.unique(plan.b_idx)), plan.nruns)
        bound, by = stack_bound_s(*counts, precision=plan.precision)
        min_bytes += stack_min_bytes(*counts)
        modeled_bytes += stack_bytes(sp.m, sp.n, sp.k, sp.entries, nseg=plan.nruns,
                                     itemsize=cd.element_size())
        row.update(bound_ms=bound * 1e3, bound_by=by)
        rows.append(row)
        tot["plain_ms"] += row["plain_ms"]
        tot["bound_ms"] += bound * 1e3
    flops = sum(2 * r["mnk"][0] * r["mnk"][1] * r["mnk"][2] * r["entries"] for r in rows)
    # what bounds the stack with the largest bound bounds the multiply
    tot["bound_by"] = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
    _emit({"phase": phase, "spans": rows, "launches_per_multiply": len(rows),
           "replan_host_s": host_s,
           "kernels_timed": [("plan" if r is None else "resident" if r else "cross")
                             for r in kernels],
           "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
           "bound_by": tot["bound_by"],
           "kernel_gflops": [flops / ms / 1e6 for ms in tot["ms"]], "flops": flops,
           "min_bytes": min_bytes, "modeled_stack_bytes": modeled_bytes,
           "max_abs_err": tot["max_abs_err"]})
    return tot


def _with_engine(on: bool, fn):
    """``fn()`` with the native index engine on or off (the NumPy path)."""
    prev = os.environ.get("DBCSR_TPU_TORCH_NATIVE")
    os.environ["DBCSR_TPU_TORCH_NATIVE"] = "1" if on else "0"
    try:
        return fn()
    finally:
        if prev is None:
            os.environ.pop("DBCSR_TPU_TORCH_NATIVE", None)
        else:
            os.environ["DBCSR_TPU_TORCH_NATIVE"] = prev


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_native_index(a, b, c) -> None:
    """The native engine on the north star's operands: its expansion and
    stack sort identical to the NumPy path and `np.lexsort`, each piece
    of the host's "index" and "plan" timed (in turns, 3 pairs), then the
    multiply's host phases on a plan-cache miss and hit under both
    engines in turns, with C bit for bit the same."""
    pieces = {k: [] for k in ("expand_native", "expand_numpy", "union1d", "sort_native",
                              "sort_lexsort")}
    for rep in range(3):
        for eng in (("numpy", "native") if rep % 2 == 0 else ("native", "numpy")):
            if eng == "native":
                got, sec = _timed(lambda: native.symbolic_product(
                    a.row_ptr, a.keys % a.nblkcols, b.row_ptr, b.keys % b.nblkcols))
            else:
                want, sec = _timed(lambda: _candidates_numpy(a, b, None, None, None))
            pieces[f"expand_{eng}"].append(sec)
    _require(all(np.array_equal(x, y) for x, y in zip(got, want)),
             "native_index: the native expansion differs from the NumPy path")
    i, j, a_ent, _ = got
    keys = i * c.nblkcols + j
    new_keys, sec = _timed(lambda: np.union1d(c.keys, np.unique(keys)))
    pieces["union1d"].append(sec)
    _require(np.array_equal(new_keys, c.keys), "native_index: C's pattern is not the product's")
    c_ent = np.searchsorted(c.keys, keys)
    g = ((c.ent_bin[c_ent].astype(np.int64) * len(a.bins) + a.ent_bin[a_ent]) * len(b.bins)
         + b.ent_bin[got[3]])
    ngroups = len(c.bins) * len(a.bins) * len(b.bins)
    c_slot = c.ent_slot[c_ent]
    for rep in range(3):
        for eng in (("lexsort", "native") if rep % 2 == 0 else ("native", "lexsort")):
            if eng == "native":
                (order, bounds), sec = _timed(lambda: native.group_sort_stacks(
                    g, ngroups, c_slot, a_ent))
            else:
                lex, sec = _timed(lambda: np.lexsort((a_ent, c_slot, g)))
            pieces[f"sort_{eng}"].append(sec)
    _require(np.array_equal(order, lex), "native_index: the native sort differs from np.lexsort")
    _require(np.array_equal(bounds, np.concatenate([[0], np.cumsum(np.bincount(
        g, minlength=ngroups))])), "native_index: the native sort's group bounds are wrong")
    groups = np.bincount(g, minlength=ngroups)
    runs = {}
    results = {}
    for eng in ("numpy", "native", "native", "numpy"):
        mm.clear_plan_cache()
        mm.reset_totals()
        phases = []
        for _ in range(2):  # a plan-cache miss, then a hit
            out = c.copy()

            def run():
                mm.multiply("N", "N", 1.0, a, b, 0.0, out)
                torch.cuda.synchronize()
            _with_engine(eng == "native", run)
            phases.append(dict(out._mm_phase_s, plan_cache=out._mm_plan_cache))
        totals = mm.read_totals()["index_engine"]
        _require(totals["expand"][eng] == 2 and totals["sort"][eng] == 1,
                 f"native_index: the {eng} engine did not run: {totals}")
        runs.setdefault(eng, []).append(phases)
        if eng not in results:
            results[eng] = out
        else:
            del out
    x, y = results["native"], results["numpy"]
    _require(np.array_equal(x.keys, y.keys) and all(
        bx.data.equal(by.data) for bx, by in zip(x.bins, y.bins)),
        "native_index: C differs between the engines")
    del results, x, y
    # "index" on plan-cache hits, 10 pairs in turns
    index_s = {"numpy": [], "native": []}
    for rep in range(10):
        for eng in (("numpy", "native") if rep % 2 == 0 else ("native", "numpy")):
            out = c.copy()
            _with_engine(eng == "native", lambda: mm.multiply("N", "N", 1.0, a, b, 0.0, out))
            _require(out._mm_plan_cache == "hit", "native_index: a repeat missed the plan cache")
            index_s[eng].append(out._mm_phase_s["index"])
            del out
    _emit({"phase": "native_index", "candidates": int(len(i)), "groups": int(ngroups),
           "largest_group": int(groups.max()), "threads": torch.get_num_threads(),
           "cpu_count": os.cpu_count(), "pieces_s": pieces,
           "median_s": {k: float(np.median(v)) for k, v in pieces.items()},
           "multiply_host_phase_s": runs, "index_s_hits_in_turns": index_s,
           "index_median_s": {k: float(np.median(v)) for k, v in index_s.items()}})


# the models' size: test_H2O's blocking, 96 block rows of 23 (2208^2)
MODEL_BLOCKS, MODEL_BLOCK, MODEL_SEED = 96, 23, 0


def _canvas_rel(x, y) -> float:
    """max |x - y| over max |y|, on the card's dense canvases."""
    dx, dy = _to_dense_device(x), _to_dense_device(y)
    return float((dx - dy).abs().max()) / max(float(dy.abs().max()), 1e-300)


def _launched_since(before: dict) -> dict:
    """The launches counted since `_counts` gave ``before``."""
    return {k: v - before[k] for k, v in _counts().items()}


def _format_legs(a, b, c0, legs, tol, reps=3) -> dict:
    """C = 0.7 A B + 0.5 C0 under each ``mm_format`` of ``legs``, after
    one untimed run: wall seconds (synchronized), host phases and device
    seconds of the last repeat, the format run, K1/K3 launches of the
    last repeat and the difference to the "stack" leg (the first)."""
    out, ref = {}, None
    try:
        for fmt in legs:
            set_config(mm_format=fmt)
            times = []
            for rep in range(reps + 1):
                c = c0.copy()
                torch.cuda.synchronize()
                before = _counts()
                t0 = time.perf_counter()
                mm.multiply("N", "N", 0.7, a, b, 0.5, c)
                torch.cuda.synchronize()
                if rep:
                    times.append(time.perf_counter() - t0)
            launched = _launched_since(before)
            ev = c._mm_device_events
            row = {"ran": c._mm_algorithm, "times_s": times, "host_phase_s": c._mm_phase_s,
                   "device_s": ev[0].elapsed_time(ev[1]) / 1e3 if ev else None,
                   "launches": launched, "c_blocks": int(c.nblks)}
            if ref is None:
                ref = c
            else:
                row["rel_to_stack"] = rel = _canvas_rel(c, ref)
                _require(rel <= tol, f"formats: {fmt} differs from stack by {rel:.3e} > {tol:.1e}")
            _require(launched["plain"] == 0, f"formats: {fmt} ran the plain versions")
            out[fmt] = row
    finally:
        set_config(mm_format="auto")
    return out


def _gemm_ms(n: int, dtype) -> dict:
    """The canvas GEMM alone (`torch.matmul` of two n x n canvases), by
    CUDA events, beside the least time the card could take for it."""
    x = torch.randn((n, n), dtype=dtype, device=resolve_device())
    y = torch.randn((n, n), dtype=dtype, device=resolve_device())
    ms = _time_ms(lambda: torch.matmul(x, y), 10)
    flops = 2.0 * n ** 3
    t_ops = flops / H100_PEAK_FLOPS[name_of(dtype)]
    t_bytes = 3 * n * n * x.element_size() / H100_BYTES_PER_S
    return {"n": n, "ms": ms, "tflops": flops / ms / 1e9, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _banded(name, band, rng, dtype):
    """A 96 x 96 block matrix of 23 x 23 blocks within ``band`` of the
    diagonal, standard-normal values."""
    sizes = np.full(MODEL_BLOCKS, MODEL_BLOCK)
    rows = [i for i in range(MODEL_BLOCKS) for j in range(MODEL_BLOCKS) if abs(i - j) <= band]
    cols = [j for i in range(MODEL_BLOCKS) for j in range(MODEL_BLOCKS) if abs(i - j) <= band]
    m = BlockSparseMatrix(name, sizes, sizes, dtype)
    m.put_blocks(rows, cols, rng.standard_normal((len(rows), MODEL_BLOCK, MODEL_BLOCK)))
    return m.finalize()


def phase_formats() -> int:
    """Every format on the models' size, the canvas GEMM alone, the north
    star forced dense, and the `.perf` gates under the planner.  Returns
    the K1 launches of the whole phase."""
    sizes = np.full(MODEL_BLOCKS, MODEL_BLOCK)
    out = {"phase": "formats", "n": MODEL_BLOCKS * MODEL_BLOCK, "block": MODEL_BLOCK}
    _reset_counts()
    mm.reset_totals()
    for dtype in (torch.float64, torch.float32):
        rng = np.random.default_rng(20261017)
        full = [make_random_matrix(nm, sizes, sizes, dtype=dtype, occupation=occ, rng=rng)
                for nm, occ in (("A", 1.0), ("B", 1.0), ("C", 0.3))]
        band = [_banded("A", 4, rng, dtype), _banded("B", 4, rng, dtype), full[2]]
        name = name_of(dtype)
        tol = 1e-12 if dtype == torch.float64 else kernel_validation_tolerance(
            "float32", MODEL_BLOCK, MODEL_BLOCKS)
        legs = ("stack", "dense", "composite", "auto")
        res = {"full": _format_legs(*full, legs, tol), "banded": _format_legs(*band, legs, tol)}
        ran = {pat: {fmt: r["ran"] for fmt, r in legs_.items()} for pat, legs_ in res.items()}
        _require(ran == {"full": {"stack": "stack", "dense": "dense", "composite": "stack",
                                  "auto": "dense"},
                         "banded": {"stack": "stack", "dense": "dense",
                                    "composite": "composite", "auto": "stack"}},
                 f"formats {name}: the formats run were {ran}")
        wanted = "smm_stack" if dtype == torch.float64 else "smm_crosspack"
        for pat in res:
            _require(res[pat]["stack"]["launches"][wanted] > 0,
                     f"formats {name} {pat}: the stack leg never launched {wanted}")
        out[name] = {"tolerance": tol, "gemm": _gemm_ms(MODEL_BLOCKS * MODEL_BLOCK, dtype), **res}
        del full, band
    out["decisions"] = mm.read_totals()["formats"]
    # the north star forced dense, beside its stack run
    ns = {}
    for fmt in ("stack", "dense"):
        set_config(mm_format=fmt)
        try:
            res = run_perf(_northstar_cfg(2), verbose=False)
        finally:
            set_config(mm_format="auto")
        _require(res["algorithms"] == [fmt] * 2, f"north star forced {fmt} ran {res['algorithms']}")
        ns[fmt] = res
    rel = _canvas_rel(ns["dense"]["matrices"]["c_out"], ns["stack"]["matrices"]["c_out"])
    _require(rel <= 1e-12, f"north star: dense differs from stack by {rel:.3e}")
    out["northstar_dense"] = {
        fmt: {"times_s": r["times_s"], "host_phase_s": r["host_phase_s"],
              "device_s": r["device_s"], "checksum": r["checksum"],
              "c_blocks": int(r["matrices"]["c_out"].nblks)} for fmt, r in ns.items()}
    out["northstar_dense"]["rel_dense_to_stack"] = rel
    out["northstar_dense"]["gemm"] = _gemm_ms(10000, torch.float64)
    del ns, res
    # the .perf gates under the planner
    gates = []
    for name, nrep in PERF_GATES:
        cfg = parse_perf_file(os.path.join(INPUTS, f"{name}.perf"))
        cfg.nrep = nrep
        res = run_perf(cfg, verbose=False)  # raises PerfChecksumError on mismatch
        gates.append({"input": name, "algorithms": res["algorithms"], "checksum": res["checksum"],
                      "refs": list(cfg.check_refs), "times_s": res["times_s"]})
    out["perf_gates_auto"] = gates
    out["launches"] = _counts()
    _emit(out)
    return out["launches"]["smm_stack"]


LIMIT_CASES = (
    ("block", dict(first_row=10, last_row=70, first_col=5, last_col=90, first_k=3, last_k=85)),
    ("element", dict(element_limits=(101, 1700, 37, 2150, 11, 2000))),
)


def _window(c, limits) -> tuple:
    """The element window (r0, r1, c0, c1, k0, k1), inclusive, of a limit set."""
    if "element_limits" in limits:
        return limits["element_limits"]
    roff, coff = c.row_blk_offsets, c.col_blk_offsets
    return (int(roff[limits["first_row"]]), int(roff[limits["last_row"] + 1]) - 1,
            int(coff[limits["first_col"]]), int(coff[limits["last_col"] + 1]) - 1,
            int(coff[limits["first_k"]]), int(coff[limits["last_k"] + 1]) - 1)


def phase_limits() -> int:
    """Block and unaligned element limits with beta 0.7 at 2208^2 under
    "auto" (K1) and "torch"; returns the K1 launches under "auto"."""
    sizes = np.full(MODEL_BLOCKS, MODEL_BLOCK)
    rng = np.random.default_rng(20261018)
    a, b, c0 = (make_random_matrix(nm, sizes, sizes, occupation=0.3, rng=rng) for nm in "ABC")
    alpha, beta = 1.3, 0.7
    da, db, dc = (_to_dense_device(m) for m in (a, b, c0))
    rows, k1 = {}, 0
    for case, limits in LIMIT_CASES:
        r0, r1, c0w, c1w, k0, k1w = _window(c0, limits)
        row = {"limits": limits, "window": [r0, r1, c0w, c1w, k0, k1w]}
        got = {}
        for driver in ("auto", "torch"):
            set_config(mm_driver=driver)
            try:
                c = c0.copy()
                _reset_counts()
                t0 = time.perf_counter()
                mm.multiply("N", "N", alpha, a, b, beta, c, **limits)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = _counts()
            finally:
                set_config(mm_driver="auto")
            _require(c._mm_algorithm == "stack", f"limits {case}: ran {c._mm_algorithm}")
            row[driver] = {"launches": counts, "wall_s": wall, "host_phase_s": c._mm_phase_s,
                           "c_blocks": int(c.nblks)}
            got[driver] = c
        la, lt = row["auto"]["launches"], row["torch"]["launches"]
        _require(la["smm_stack"] > 0 and la["plain"] == 0, f"limits {case}: auto launched {la}")
        _require(lt["plain"] > 0 and lt["smm_stack"] == 0, f"limits {case}: torch launched {lt}")
        k1 += la["smm_stack"]
        _require(np.array_equal(got["auto"].keys, got["torch"].keys),
                 f"limits {case}: C's patterns differ between the drivers")
        row["rel_auto_to_torch"] = rel = _canvas_rel(got["auto"], got["torch"])
        _require(rel <= 1e-12, f"limits {case}: auto vs torch {rel:.3e} > 1e-12")
        want = dc.clone()
        want[r0:r1 + 1, c0w:c1w + 1] = (alpha * (da[r0:r1 + 1, k0:k1w + 1] @ db[k0:k1w + 1,
                                                                             c0w:c1w + 1])
                                        + beta * dc[r0:r1 + 1, c0w:c1w + 1])
        dgot = _to_dense_device(got["auto"])
        row["rel_to_oracle"] = rel = float((dgot - want).abs().max()) / float(want.abs().max())
        _require(rel <= 1e-12, f"limits {case}: against the dense oracle {rel:.3e} > 1e-12")
        outside = torch.ones_like(dgot, dtype=torch.bool)
        outside[r0:r1 + 1, c0w:c1w + 1] = False
        _require(bool(torch.equal(dgot[outside], dc[outside])),
                 f"limits {case}: C outside the window changed")
        rows[case] = row
        del got, want, dgot, outside
    _emit({"phase": "limits", "n": MODEL_BLOCKS * MODEL_BLOCK, "block": MODEL_BLOCK,
           "occupancy": 0.3, "alpha": alpha, "beta": beta, "tolerance": 1e-12, **rows})
    return k1


def _kernel_row(name: str, launches: int, timing: dict, ki: int = 0) -> dict:
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": timing["max_abs_err"][ki],
            "ms": timing["ms"][ki], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": None}


def phase_northstar_f32() -> dict:
    _reset_counts()
    res = run_perf(_northstar_cfg(3, data_type=1), verbose=False)
    counts = _counts()
    _require(counts["smm_crosspack"] > 0, "f32 north star: the crosspack kernel never launched")
    _require(counts["smm_stack"] == 0 and counts["smm_crosspack_resident"] == 0,
             f"f32 north star: other kernels launched: {counts}")
    _require(counts["plain"] == 0, f"f32 north star: the plain versions ran {counts['plain']} times")
    _require(all(s[4] == "smm_crosspack" for s in res["spans"]),
             f"f32 north star: not every span took crosspack: {res['spans']}")
    longest = max(s[5] for s in res["spans"])
    out = {"phase": "northstar_f32", "shape": [10000, 10000, 10000], "block": 23,
           "occupancy": 0.1, "dtype": "float32", "mm_driver": "auto",
           **_run_summary(res, 3, counts)}
    out.update(_against_torch_driver(res, _northstar_cfg(1, data_type=1),
                                     kernel_validation_tolerance("float32", 23, longest), 1e-6))
    out["longest_run"] = longest
    _emit(out)
    operands = _operands(res, _northstar_cfg(1))
    del res
    timing = _stacks_phase("northstar_f32_stacks", *operands)
    _plan_ab("northstar_f32_plan", *operands)
    return _kernel_row("smm_crosspack", counts["smm_crosspack"], timing)


def _plan_ab(phase: str, a, b, c, pairs: int = 3) -> None:
    """Host seconds of planning the product's stacks for the base kernel
    (``mm_driver="pallas"``) and for crosspack (``"auto"``), in turns on
    the same operands in one process: what dealing runs into packs adds."""
    i, j, a_ent, b_ent = _candidates(a, b, None)
    keys = i * c.nblkcols + j
    plan_s = {"pallas": [], "auto": []}
    try:
        for rep in range(pairs):
            for driver in (("pallas", "auto") if rep % 2 == 0 else ("auto", "pallas")):
                set_config(mm_driver=driver)
                t0 = time.perf_counter()
                spans = _build_spans(c, a, b, keys, a_ent, b_ent)
                plan_s[driver].append(time.perf_counter() - t0)
                want = "smm_stack" if driver == "pallas" else "smm_crosspack"
                _require(all(sp.driver == want for sp in spans),
                         f"{phase}: {driver} planned {[sp.driver for sp in spans]}")
                del spans
    finally:
        set_config(mm_driver="auto")
    _emit({"phase": phase, "plan_s": plan_s,
           "median_s": {d: float(np.median(v)) for d, v in plan_s.items()}})


def _operands(res, cfg):
    """op(A), op(B) and C of a `run_perf` result."""
    mats = res["matrices"]
    return (_effective(mats["a"], cfg.transa), _effective(mats["b"], cfg.transb),
            mats["c_out"])


def _block_shapes(cfg):
    sizes = [np.unique(expand_block_sizes(total, pat))
             for total, pat in ((cfg.m, cfg.m_sizes), (cfg.n, cfg.n_sizes), (cfg.k, cfg.k_sizes))]
    return [tuple(int(x) for x in t) for t in itertools.product(*sizes)]


RESIDENT_CANDIDATES = ("test_H2O", "test_rect2_sparse", "test_rect1_sparse",
                       "test_square_sparse", "test_singleblock")


def phase_resident_f32() -> dict:
    """`test_H2O` as sreal through K4, steered there by a tuned
    ``crosspack_vmem`` row; the largest other `.perf` input whose
    operands fit the persisting-L2 limit if its do not."""
    limit = resident_limit_bytes(resolve_device())
    prev_dir = os.environ.get("DBCSR_TPU_TORCH_PARAMS_DIR")
    skipped = []
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["DBCSR_TPU_TORCH_PARAMS_DIR"] = tmp
        try:
            for name in RESIDENT_CANDIDATES:
                cfg = parse_perf_file(os.path.join(INPUTS, f"{name}.perf"))
                cfg.data_type, cfg.nrep, cfg.check = 1, 2, False
                for m, n, k in _block_shapes(cfg):
                    P, R = choose_pack(m, n, k)
                    params.save_entry({"m": m, "n": n, "k": k, "dtype": "float32",
                                       "driver": "pallas", "variant": "crosspack_vmem",
                                       "grouping": R, "pack_p": P, "gflops": 0.0})
                _reset_counts()
                res = run_perf(cfg, verbose=False)
                counts = _counts()
                mats = res["matrices"]
                operand_bytes = max(
                    x.data.numel() * x.data.element_size() + y.data.numel() * y.data.element_size()
                    for x in mats["a"].bins for y in mats["b"].bins)
                if counts["smm_crosspack_resident"] > 0:
                    break
                skipped.append({"input": name, "operand_bytes": operand_bytes})
                _require(operand_bytes > limit,
                         f"{name}: operands fit ({operand_bytes} <= {limit} B) but K4 never launched")
            else:
                raise RuntimeError(f"no .perf input fits the persisting-L2 limit {limit} B")
            _require(counts["plain"] == 0 and counts["smm_stack"] == 0,
                     f"{name}: other launches on the resident path: {counts}")
            longest = max(s[5] for s in res["spans"])
            out = {"phase": "resident_f32", "input": name, "dtype": "float32",
                   "persisting_l2_bytes": limit, "operand_bytes": operand_bytes,
                   "skipped": skipped, "tuned_rows": params.params_path(),
                   **_run_summary(res, 2, counts)}
            k_max = max(k for _, _, k in _block_shapes(cfg))
            out.update(_against_torch_driver(
                res, cfg, kernel_validation_tolerance("float32", k_max, longest), 1e-6))
            out["longest_run"] = longest
            _emit(out)
            operands = _operands(res, cfg)
            del res, mats
            timing = _stacks_phase("resident_f32_stacks", *operands,
                                   kernels=(True, False), reps=10)
        finally:
            if prev_dir is None:
                os.environ.pop("DBCSR_TPU_TORCH_PARAMS_DIR", None)
            else:
                os.environ["DBCSR_TPU_TORCH_PARAMS_DIR"] = prev_dir
            params.invalidate()
    return _kernel_row("smm_crosspack_resident", counts["smm_crosspack_resident"], timing)


# the models' workload: the density drawn from MODEL_SEED at the models'
# size; steps and tolerances of each loop
PURIFY_STEPS = 6
SIGN_STEPS, SIGN_EPS = 25, 1e-10
INVSQRT_TOL = 1e-10
SIGN_F32_STEPS = 3


def _drive(driver: str, loop, fmt: str = "auto"):
    """``loop()`` under ``mm_driver=driver`` and ``mm_format=fmt``, with
    the kernel counts, the engine's totals and the allocator's peak set
    to 0 just before it and read just after (``pool``: the chains' frees
    and the caching allocator's bytes, `core.mempool.pool_stats`)."""
    set_config(mm_driver=driver, mm_format=fmt)
    try:
        _reset_counts()
        mm.reset_totals()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        freed0 = mempool.pool_stats()
        t0 = time.perf_counter()
        out = loop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        totals = mm.read_totals()
        pool = mempool.pool_stats(resolve_device(None))
    finally:
        set_config(mm_driver="auto", mm_format="auto")
    for key in ("freed", "freed_bytes"):
        pool[key] -= freed0[key]
    return out, {"wall_s": wall, "launches": counts, **totals, "pool": pool}


def _history_diff(got, want) -> dict:
    """Each history entry's difference, relative to the entry and, for
    the bound, to the larger of the entry and the history's first (a
    residual at the rounding floor differs by its own size)."""
    _require(len(got) == len(want), f"histories differ in length: {len(got)} vs {len(want)}")
    d = np.abs(np.asarray(got) - np.asarray(want))
    w = np.abs(np.asarray(want))
    return {"rel_entry": (d / np.maximum(w, 1e-300)).tolist(),
            "rel_bound": float((d / np.maximum(w, w[0])).max())}


def _iterate_diff(got, want) -> float:
    """max |got - want| over max |want|, on the union of the patterns."""
    return maxabs_norm(added(got, want, 1.0, -1.0)) / maxabs_norm(want)


def _squared(x):
    """X^2 through the engine (the driver in force)."""
    x2 = BlockSparseMatrix("X2", x.row_blk_sizes, x.col_blk_sizes, x.dtype, x.dist,
                           device=x.device)
    mm.multiply("N", "N", 1.0, x, x, 0.0, x2)
    return x2


def _sign_measure(x) -> float:
    """||X^2 - I||_F, the sign iteration's convergence measure."""
    return frobenius_norm(add_on_diag(_squared(x), -1.0))


def _idempotency(p) -> float:
    """|tr(P^2) - tr(P)|, McWeeny's convergence measure."""
    return abs(trace(_squared(p)) - trace(p))


def _model_loops(p0, sign_steps: int, sign_eps):
    """The sign input (``p0`` - 0.5 I) and the three loops on ``p0``."""
    a = copy(p0, "A")
    add_on_diag(a, -0.5)  # spectrum straddling zero
    s = copy(p0, "S")
    add_on_diag(s, 0.5)  # SPD, spectrum near [0.9, 1.1]

    def invsqrt():
        hist = []
        z, sf, iters = invsqrt_iteration(s, tol=INVSQRT_TOL, history=hist)
        return z, hist, sf, iters

    return a, {
        "purify": lambda: mcweeny_purify(p0, steps=PURIFY_STEPS),
        "sign": lambda: sign_iteration(a, steps=sign_steps, filter_eps=sign_eps),
        "invsqrt": invsqrt,
    }


def _in_turns(first: str, first_info: dict, second: str, drive, check) -> dict:
    """Two variants of one loop in turns: the phase's own run of
    ``first`` (``first_info``), then ``second``, ``first``, ``second``;
    ``drive(variant)`` runs one and returns `_drive`'s (output, info),
    and ``check(variant, output, info)`` holds it against the plain
    version and returns what it found."""
    keys = ("wall_s", "host_phase_s", "device_s", "formats", "index_engine", "launches")
    out = {first: [{k: first_info[k] for k in keys}], second: []}
    for variant in (second, first, second):
        result, info = drive(variant)
        out[variant].append({k: info[k] for k in keys} | check(variant, result, info))
    return out


def phase_models() -> dict:
    p0 = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, occ=0.2, seed=MODEL_SEED)
    a, loops = _model_loops(p0, SIGN_STEPS, SIGN_EPS)
    x0 = copy(a, "X0")
    scale(x0, 1.0 / gershgorin_norm(a))  # the sign iteration's start
    start = {"purify": _idempotency(p0), "sign": _sign_measure(x0)}
    rows = {}
    k1 = 0
    for name, loop in loops.items():
        runs = {}
        # the planner under "auto"; the plain version on the stack format
        for driver, fmt in (("auto", "auto"), ("torch", "stack")):
            out, info = _drive(driver, loop, fmt)
            runs[driver] = (out, info)
        (xa, ha, *rest_a), info_a = runs["auto"]
        (xt, ht, *rest_t), info_t = runs["torch"]
        la, lt = info_a["launches"], info_t["launches"]
        _require(la["plain"] == 0 and la["smm_crosspack"] == 0
                 and la["smm_crosspack_resident"] == 0,
                 f"models {name} under auto: launches {la}")
        dense = sum(n for d, n in info_a["formats"].items() if d.startswith("dense:"))
        if name == "sign":
            _require(la["smm_stack"] > 0, f"models sign under auto: K1 never launched: {la}")
        else:
            _require(dense > 0, f"models {name} under auto: no dense multiply: "
                                f"{info_a['formats']}")
        _require(lt["plain"] > 0 and lt["smm_stack"] == 0 and lt["smm_crosspack"] == 0,
                 f"models {name} under torch: launches {lt}")
        k1 += la["smm_stack"]
        bound = 10 * SIGN_EPS if name == "sign" else 1e-10
        hist = _history_diff(ha, ht)
        rel_x = _iterate_diff(xa, xt)
        _require(hist["rel_bound"] <= bound and rel_x <= bound,
                 f"models {name}: auto vs torch history {hist['rel_bound']:.3e}, "
                 f"iterate {rel_x:.3e} > {bound:.1e}")
        row = {"history_auto": ha, "history_torch": ht, "history_rel": hist["rel_entry"],
               "history_rel_bound": hist["rel_bound"], "iterate_rel": rel_x, "bound": bound,
               "auto": info_a, "torch": info_t}
        if name == "purify":
            row["measure"] = {"start": start["purify"], "auto": _idempotency(xa),
                              "torch": _idempotency(xt)}
        elif name == "sign":
            row["measure"] = {"start": start["sign"], "auto": _sign_measure(xa),
                              "torch": _sign_measure(xt)}
        else:
            (sf_a, it_a), (sf_t, it_t) = rest_a, rest_t
            _require(it_a == it_t and sf_a == sf_t,
                     f"models invsqrt: iterations {it_a}/{it_t}, scale {sf_a}/{sf_t}")
            _require(ha[-1] < INVSQRT_TOL and ht[-1] < INVSQRT_TOL,
                     f"models invsqrt: residual {ha[-1]:.3e}/{ht[-1]:.3e} did not reach "
                     f"{INVSQRT_TOL:.0e}")
            row.update(iterations=it_a, scale_factor=sf_a, tol=INVSQRT_TOL,
                       measure={"start": ha[0], "auto": ha[-1], "torch": ht[-1]})
        if name != "invsqrt":
            m = row["measure"]
            _require(m["auto"] < m["start"] and m["torch"] < m["start"],
                     f"models {name}: the convergence measure did not fall: {m}")
        def check(variant, result, info, name=name, xt=xt, ht=ht, bound=bound):
            """Every run in turns against the "torch" run, and K1 on the
            stack format's filled iterates."""
            x, h = result[:2]
            d_h, d_x = _history_diff(h, ht)["rel_bound"], _iterate_diff(x, xt)
            _require(d_h <= bound and d_x <= bound,
                     f"models {name} ({variant}, in turns) vs torch: history {d_h:.3e}, "
                     f"iterate {d_x:.3e} > {bound:.1e}")
            if variant in ("stack", "native", "numpy"):
                _require(info["launches"]["smm_stack"] > 0,
                         f"models {name} ({variant}, in turns): K1 never launched")
            return {"history_rel_bound": d_h, "iterate_rel": d_x}

        if name == "sign":  # the index engine against the NumPy path
            row["in_turns"] = _in_turns("native", info_a, "numpy", lambda eng: _with_engine(
                eng == "native", lambda: _drive("auto", loop)), check)
        else:  # the planner's formats against the stack format through K1
            row["in_turns"] = _in_turns("auto", info_a, "stack",
                                        lambda fmt: _drive("auto", loop, fmt), check)
        rows[name] = row
        del runs, xa, xt
    _emit({"phase": "models", "blocks": MODEL_BLOCKS, "block": MODEL_BLOCK,
           "n": MODEL_BLOCKS * MODEL_BLOCK, "dtype": "float64", "seed": MODEL_SEED,
           "density_blocks": int(p0.nblks), "purify_steps": PURIFY_STEPS,
           "sign_steps": SIGN_STEPS, "sign_filter_eps": SIGN_EPS, "invsqrt_tol": INVSQRT_TOL,
           **rows})
    return k1


def phase_models_f32() -> int:
    p0 = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, occ=0.2, seed=MODEL_SEED,
                           dtype=torch.float32)
    _, loops = _model_loops(p0, SIGN_F32_STEPS, None)
    # the stack format in both legs: this phase checks K3 on the loop
    (xa, ha), info_a = _drive("auto", loops["sign"], "stack")
    (xt, ht), info_t = _drive("torch", loops["sign"], "stack")
    la = info_a["launches"]
    _require(la["smm_crosspack"] > 0 and la["smm_stack"] == 0 and la["plain"] == 0,
             f"models_f32 under auto: launches {la}")
    tol = kernel_validation_tolerance("float32", MODEL_BLOCK, info_a["longest_run"])
    rel_x = _iterate_diff(xa, xt)
    _require(rel_x <= tol, f"models_f32: auto vs torch iterate {rel_x:.3e} > {tol:.1e}")
    _emit({"phase": "models_f32", "loop": "sign", "dtype": "float32", "mm_format": "stack",
           "steps": SIGN_F32_STEPS,
           "history_auto": ha, "history_torch": ht, "iterate_rel": rel_x, "tolerance": tol,
           "longest_run": info_a["longest_run"], "auto": info_a, "torch": info_t})
    return la["smm_crosspack"]


# the tensor phases: the RI step of the water system, (mu nu|P) M(P,Q) ->
# (mu nu|Q), on test_H2O's blocking (MODEL_BLOCKS molecules of 23
# orbitals) and the density's pair pattern; T's values from TENSOR_SEED
TENSOR_SEED = 20261017
# the legs' depths (molecules), each cut from MODEL_BLOCKS; the batched
# leg runs TENSOR_BATCHES mu batches
TENSOR_LEGS = {"remap": 32, "batched": 48, "f32": 48, "contract_test": 12}
TENSOR_BATCHES = 4
RI_KW = dict(contract_a=(2,), notcontract_a=(0, 1), contract_b=(0,), notcontract_b=(1,),
             map_1=(0, 1), map_2=(2,))


def _ri_pattern(d) -> dict:
    """T's block indices (mu, nu, P) where the pair pattern ``d`` has (mu,
    nu) and (mu, P), and the counts the phase reckons from the pattern:
    T's and C's blocks and the block products."""
    rows, cols = d.entry_coords()
    per_row = [cols[rows == mu] for mu in range(d.nblkrows)]
    idx = np.concatenate([np.stack([np.full(len(s) ** 2, mu), np.repeat(s, len(s)),
                                    np.tile(s, len(s))], axis=1)
                          for mu, s in enumerate(per_row) if len(s)]).astype(np.int64)
    row_len = np.array([len(s) for s in per_row], np.int64)
    c_blocks = sum(len(s) * len(np.unique(np.concatenate([per_row[p] for p in s])))
                   for s in per_row if len(s))
    return {"idx": idx, "t_blocks": len(idx), "c_blocks": int(c_blocks),
            "products": int(row_len[idx[:, 2]].sum()), "m_blocks": int(d.nblks)}


def _ri_operands(nmol: int, dtype=torch.float64):
    """T(mu,nu,P), mapped rows (mu,nu) cols (P), with seeded normal blocks
    drawn on the card; M(P,Q), the density as a rank-2 tensor; the
    pattern's counts; and a maker of empty C tensors (mu,nu|Q)."""
    d = make_test_density(nmol, MODEL_BLOCK, occ=0.2, seed=MODEL_SEED, dtype=dtype)
    pat = _ri_pattern(d)
    sizes = [[MODEL_BLOCK] * nmol] * 3
    t = create_tensor("T", sizes, (0, 1), (2,), dtype=dtype)
    idx = pat["idx"]
    gen = torch.Generator(device=resolve_device()).manual_seed(TENSOR_SEED + nmol)
    blocks = torch.randn((len(idx), MODEL_BLOCK ** 2, MODEL_BLOCK), generator=gen,
                         dtype=dtype, device=resolve_device())
    t.matrix.stage_device_blocks(idx[:, 0] * nmol + idx[:, 1], idx[:, 2], blocks)
    del blocks
    t.finalize()
    m = copy_matrix_to_tensor(d, create_tensor("M", sizes[:2], (0,), (1,), dtype=dtype))
    del d

    def empty_c(name="C", row_dims=(0, 1), col_dims=(2,)):
        return create_tensor(name, sizes, row_dims, col_dims, dtype=dtype).finalize()
    return t, m, pat, empty_c


def _blocks_rel(got, want) -> dict:
    """C's patterns equal, then max |got - want| over max |want|, both on
    the card a bounded chunk of blocks at a time, and both checksums."""
    _require(np.array_equal(got.matrix.keys, want.matrix.keys),
             "tensor: C's block patterns differ")
    diff = scale_ = 0.0
    for bg, bw in zip(got.matrix.bins, want.matrix.bins):
        for xg, xw in zip(bg.data.split(1 << 12), bw.data.split(1 << 12)):
            diff = max(diff, float((xg.double() - xw.double()).abs().max()))
            scale_ = max(scale_, float(xw.double().abs().max()))
    cs = {k: (got.checksum(pos=p), want.checksum(pos=p))
          for k, p in (("checksum", False), ("checksum_pos", True))}
    return {"rel_elementwise": diff / max(scale_, 1e-300),
            "bit_identical": diff == 0.0,
            **{f"rel_{k}": abs(g - w) / abs(w) for k, (g, w) in cs.items()},
            **{k: g for k, (g, _) in cs.items()}}


def _contract_run(driver: str, t, m, c, **kw) -> dict:
    """``contract`` into ``c`` under ``mm_driver=driver``, with the kernel
    counts, the engine's totals, the timer and the allocator's peak set to
    0 just before it and read just after (``alloc_retries``: the times
    the caching allocator had to free its cache and retry a cudaMalloc)."""
    set_config(mm_driver=driver)
    try:
        _reset_counts()
        mm.reset_totals()
        timings.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        retries0 = mempool.pool_stats(resolve_device())["num_alloc_retries"]
        t0 = time.perf_counter()
        flops = contract(1.0, t, m, kw.pop("beta", 0.0), c, **RI_KW, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        totals = mm.read_totals()
        retries = mempool.pool_stats(resolve_device())["num_alloc_retries"] - retries0
    finally:
        set_config(mm_driver="auto")
    return {"driver": driver, "wall_s": wall, "flops": flops,
            "nsplit": getattr(c.matrix, "_tas_nsplit", None), "alloc_retries": retries,
            "launches": counts, **totals,
            "timed_s": {k: {"calls": st.calls, "total": st.total, "self": st.self_time}
                        for k, st in timings._stats.items()},
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
            "c_blocks": int(c.nblks)}


def phase_tensor() -> dict:
    """The RI contraction at full width through `tensor.contract` (TAS
    split, K1's tiled path), held block by block against the plain
    driver in two mu batches; returns K1's row for this path."""
    gc.collect()
    torch.cuda.empty_cache()
    t, m, pat, empty_c = _ri_operands(MODEL_BLOCKS)
    _require(t.nblks == pat["t_blocks"] and m.nblks == pat["m_blocks"],
             f"tensor: T/M hold {t.nblks}/{m.nblks} blocks, the pattern {pat['t_blocks']}/"
             f"{pat['m_blocks']}")
    mnk = (MODEL_BLOCK ** 2, MODEL_BLOCK, MODEL_BLOCK)
    path = stack_kernel.kernel_path(*mnk)
    _require(path == "tiled", f"tensor: (529,23,23) takes K1's {path} path")
    c = empty_c()
    run = _contract_run("auto", t, m, c)
    ngroups = run["multiplies"]
    la = run["launches"]
    _require(la["smm_stack"] > 0 and la["plain"] == 0 and la["smm_crosspack"] == 0,
             f"tensor: launches {la}")
    _require(c.nblks == pat["c_blocks"], f"tensor: C holds {c.nblks} blocks, the pattern "
                                         f"{pat['c_blocks']}")
    _require(run["flops"] == 2 * int(np.prod(mnk)) * pat["products"],
             f"tensor: {run['flops']} flops, the pattern {2 * int(np.prod(mnk)) * pat['products']}")
    _require(all(f.startswith("stack:") for f in run["formats"]),
             f"tensor: formats {run['formats']}")
    _require(run["index_engine"]["expand"]["native"] == ngroups,
             f"tensor: the native expansion ran {run['index_engine']}")
    _require(run["plan_cache"]["hit"] == 0, f"tensor: the groups' plans collided: "
                                            f"{run['plan_cache']}")
    bound, by = stack_bound_s("float64", *mnk, pat["products"], pat["t_blocks"],
                              pat["m_blocks"], pat["c_blocks"])
    out = {"phase": "tensor", "molecules": MODEL_BLOCKS, "block": MODEL_BLOCK,
           "dtype": "float64", "mnk": list(mnk), "path": path,
           "t_blocks": pat["t_blocks"], "m_blocks": pat["m_blocks"],
           "c_blocks": pat["c_blocks"], "products": pat["products"],
           "t_bytes": pat["t_blocks"] * mnk[0] * mnk[2] * 8,
           "c_bytes": pat["c_blocks"] * mnk[0] * mnk[1] * 8,
           "groups": ngroups, "bound_ms": bound * 1e3, "bound_by": by,
           "stack_ms": run["stack_device_s"] * 1e3, "auto": run}
    # the plain driver, block by block, in two mu batches (a second C
    # beside the first would need 18.6 GB more)
    half = MODEL_BLOCKS // 2
    refs, diffs = [], {"diff": 0.0, "scale": 0.0}
    for lo, hi in ((0, half - 1), (half, MODEL_BLOCKS - 1)):
        ref = empty_c("C_ref")
        refs.append(_contract_run("torch", t, m, ref, bounds_2=[(lo, hi), None]))
        lt = refs[-1]["launches"]
        _require(lt["plain"] > 0 and lt["smm_stack"] == 0, f"tensor: torch launched {lt}")
        rk = ref.matrix.keys
        pos = np.searchsorted(c.matrix.keys, rk)
        _require(bool(np.all(c.matrix.keys[np.minimum(pos, c.nblks - 1)] == rk)),
                 "tensor: the plain batch holds blocks C lacks")
        mu = rk // c.matrix.nblkcols // MODEL_BLOCKS
        _require(bool(np.all((mu >= lo) & (mu <= hi))), "tensor: a batch left its mu range")
        _require(len(c.matrix.bins) == len(ref.matrix.bins) == 1,
                 "tensor: C has more than one block shape")
        cb, rb = c.matrix.bins[0].data, ref.matrix.bins[0].data
        slots = c.matrix.ent_slot[pos]
        for s0 in range(0, len(rk), 1 << 12):
            x = cb[torch.from_numpy(slots[s0: s0 + (1 << 12)].astype(np.int64)).to(cb.device)]
            y = rb[torch.from_numpy(ref.matrix.ent_slot[s0: s0 + (1 << 12)].astype(
                np.int64)).to(cb.device)]
            diffs["diff"] = max(diffs["diff"], float((x - y).abs().max()))
            diffs["scale"] = max(diffs["scale"], float(y.abs().max()))
        refs[-1]["checksums"] = (ref.checksum(), ref.checksum(pos=True))
        refs[-1]["c_blocks_batch"] = int(ref.nblks)
        del ref, cb, rb
    _require(sum(r["c_blocks_batch"] for r in refs) == c.nblks,
             "tensor: the plain batches do not cover C")
    rel = diffs["diff"] / diffs["scale"]
    cs, cs_pos = c.checksum(), c.checksum(pos=True)
    rel_cs = abs(cs - sum(r["checksums"][0] for r in refs)) / abs(cs)
    rel_pos = abs(cs_pos - sum(r["checksums"][1] for r in refs)) / abs(cs_pos)
    _require(rel <= 1e-10 and rel_cs <= 1e-12 and rel_pos <= 1e-12,
             f"tensor: K1 vs the plain driver rel {rel:.3e} (<= 1e-10), checksums "
             f"{rel_cs:.3e}/{rel_pos:.3e} (<= 1e-12)")
    plain_ms = sum(r["stack_device_s"] for r in refs) * 1e3
    out.update(rel_to_plain=rel, max_abs_err=diffs["diff"], rel_checksum=rel_cs,
               rel_checksum_pos=rel_pos, checksum=cs, checksum_pos=cs_pos,
               plain_stack_ms=plain_ms, torch_batches=refs)
    _emit(out)
    del c, t, m
    return {"launches": la["smm_stack"], "path": path, "ms": out["stack_ms"],
            "plain_ms": plain_ms, "bound_ms": out["bound_ms"], "bound_by": by,
            "max_abs_err": diffs["diff"], "mnk": list(mnk)}


def phase_tensor_legs() -> int:
    """The smaller legs, each at a depth cut to `TENSOR_LEGS`: remap and
    `tensor_copy` (32 molecules), a batched contraction (48), f32 (48)
    and `contract_test` against a dense einsum on the host (12).
    Returns K1's launches."""
    out = {"phase": "tensor_legs"}
    k1 = 0
    # remap and tensor_copy: (mu|nu,Q), then back to (mu,nu|Q), bit for bit
    n = TENSOR_LEGS["remap"]
    t, m, _, empty_c = _ri_operands(n)
    c1, c2 = empty_c("C1"), empty_c("C2", (0,), (1, 2))
    r1 = _contract_run("auto", t, m, c1)
    r2 = _contract_run("auto", t, m, c2)
    c3 = empty_c("C3")
    tensor_copy(c3, c2)
    back = remap(c2, (0, 1), (2,), name="C2_back")
    for name, x in (("tensor_copy", c3), ("remap", back)):
        _require(np.array_equal(x.matrix.keys, c1.matrix.keys) and all(
            bx.data.equal(b1.data) for bx, b1 in zip(x.matrix.bins, c1.matrix.bins)),
            f"tensor_legs: {name} back to (mu,nu|Q) is not bit for bit the direct contraction")
    k1 += r1["launches"]["smm_stack"] + r2["launches"]["smm_stack"]
    out["remap"] = {"molecules": n, "c_blocks": int(c1.nblks), "bit_identical": True,
                    "direct": r1, "via_remap": r2}
    del t, m, c1, c2, c3, back
    # batched: four mu batches with filter_eps, against one contraction
    n = TENSOR_LEGS["batched"]
    per = -(-n // TENSOR_BATCHES)
    t, m, _, empty_c = _ri_operands(n)
    cu, cb = empty_c("Cu"), empty_c("Cb")
    ru = _contract_run("auto", t, m, cu, filter_eps=1e-10)
    batches = []
    with batched_contraction(cb):
        for lo in range(0, n, per):
            batches.append(_contract_run("auto", t, m, cb, beta=1.0, filter_eps=1e-10,
                                         bounds_2=[(lo, min(lo + per, n) - 1), None]))
    cmp = _blocks_rel(cb, cu)
    _require(cmp["rel_elementwise"] <= 1e-12, f"tensor_legs: batched vs one contraction "
                                              f"{cmp['rel_elementwise']:.3e} > 1e-12")
    k1 += ru["launches"]["smm_stack"] + sum(b["launches"]["smm_stack"] for b in batches)
    out["batched"] = {"molecules": n, "batches": len(batches), "filter_eps": 1e-10, **cmp,
                      "unbatched": ru, "batched_wall_s": [b["wall_s"] for b in batches],
                      "batched_nsplit": [b["nsplit"] for b in batches]}
    del cu, cb
    # f32 through the kernel "auto" picks, against the plain driver
    n = TENSOR_LEGS["f32"]
    t32, m32, _, empty_c32 = _ri_operands(n, torch.float32)
    ca, ct = empty_c32("Ca"), empty_c32("Ct")
    ra = _contract_run("auto", t32, m32, ca)
    rt = _contract_run("torch", t32, m32, ct)
    kernel = [k for k in ("smm_stack", "smm_crosspack", "smm_crosspack_resident")
              if ra["launches"][k]]
    _require(len(kernel) == 1 and ra["launches"]["plain"] == 0,
             f"tensor_legs f32: launches {ra['launches']}")
    mnk = (MODEL_BLOCK ** 2, MODEL_BLOCK, MODEL_BLOCK)
    path = (stack_kernel.kernel_path(*mnk) if kernel[0] == "smm_stack"
            else crosspack_kernel.kernel_path(torch.float32, choose_pack(*mnk), *mnk))
    tol = kernel_validation_tolerance("float32", MODEL_BLOCK, ra["longest_run"])
    cmp = _blocks_rel(ca, ct)
    _require(cmp["rel_elementwise"] <= tol and cmp["rel_checksum"] <= 1e-6,
             f"tensor_legs f32: {cmp['rel_elementwise']:.3e} > {tol:.1e} or checksum "
             f"{cmp['rel_checksum']:.3e} > 1e-6")
    if kernel[0] == "smm_stack":
        k1 += ra["launches"]["smm_stack"]
    out["f32"] = {"molecules": n, "kernel": kernel[0], "path": path, "tolerance": tol,
                  **cmp, "auto": ra, "torch": rt}
    del t32, m32, ca, ct
    # contract_test: the dense einsum oracle on the host
    n = TENSOR_LEGS["contract_test"]
    t, m, _, empty_c = _ri_operands(n)
    msgs = []
    ok = contract_test(1.0, t, m, 0.0, empty_c(), **RI_KW, io=msgs.append)
    _require(ok, f"tensor_legs: contract_test failed: {msgs}")
    out["contract_test"] = {"molecules": n, "ok": ok, "message": msgs[0].strip()}
    out["k1_launches"] = k1
    _emit(out)
    return k1


# the integrity plane's counters that a phase injecting nothing must
# leave at zero: a kernel that starts failing on the card fails the
# smoke instead of running on another driver
_INTEGRITY_COUNTERS = ("dbcsr_tpu_driver_failures_total", "dbcsr_tpu_driver_fallback_total",
                       "dbcsr_tpu_abft_mismatches_total", "dbcsr_tpu_chain_rollback_total")


def _integrity_counts() -> dict:
    return {name: {json.dumps(lab, sort_keys=True): v for lab, v in metrics.counter_items(name)}
            for name in _INTEGRITY_COUNTERS}


def _clean(phase: str, fn, *args):
    """Run a phase that injects nothing: no fault may be configured, and
    it must end with zero driver failures, fallbacks, ABFT mismatches
    and rollbacks."""
    _require(not faults.active(), f"{phase}: a fault spec is configured")
    metrics.reset()
    out = fn(*args)
    took = {k: v for k, v in _integrity_counts().items() if v}
    _require(not took, f"{phase} injects nothing but took the integrity plane: {took}")
    return out


def _ctr(name: str, **labels) -> float:
    return sum(v for lab, v in metrics.counter_items(name)
               if all(lab.get(k) == x for k, x in labels.items()))


def _expect_counts(what: str, failures: dict, fallbacks: dict) -> dict:
    """The failure and fallback counters must read exactly ``failures``
    ({(driver, kind): n}) and ``fallbacks`` ({(from, to): n})."""
    got_f = {(lab["driver"], lab["kind"]): v
             for lab, v in metrics.counter_items("dbcsr_tpu_driver_failures_total")}
    got_b = {(lab["from"], lab["to"]): v
             for lab, v in metrics.counter_items("dbcsr_tpu_driver_fallback_total")}
    _require(got_f == failures and got_b == fallbacks,
             f"resilience {what}: failures {got_f} (want {failures}), "
             f"fallbacks {got_b} (want {fallbacks})")
    return {"failures": {f"{d}:{k}": v for (d, k), v in got_f.items()},
            "fallbacks": {f"{a}->{b}": v for (a, b), v in got_b.items()}}


def _product(a, b, c0, alpha=0.7, beta=0.5):
    """C = alpha A B + beta C0 on a copy of C0, synchronized."""
    c = c0.copy()
    mm.multiply("N", "N", alpha, a, b, beta, c)
    torch.cuda.synchronize()
    return c


def _resilience_operands(dtype, occ=(0.2, 0.2, 0.3), seed=20261018, device=None):
    sizes = np.full(MODEL_BLOCKS, MODEL_BLOCK)
    rng = np.random.default_rng(seed)
    return [make_random_matrix(nm, sizes, sizes, dtype=dtype, occupation=o, rng=rng,
                               device=device) for nm, o in zip("ABC", occ)]


def phase_resilience() -> dict:
    """The failover chain on the card, at `test_H2O`'s blocking (2208^2),
    f64 and f32: a failed K1 launch, non-finite output, the breaker, the
    crosspack demotion, the canvas failover and the host driver, each
    fault counted exactly; then one `.perf` gate under a failing launch.
    Returns K1's and K3's launches."""
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "resilience", "n": MODEL_BLOCKS * MODEL_BLOCK, "block": MODEL_BLOCK}
    key64, key32 = (MODEL_BLOCK,) * 3 + ("float64",), (MODEL_BLOCK,) * 3 + ("float32",)
    _reset_counts()
    try:
        set_config(mm_format="stack")
        a, b, c0 = _resilience_operands(torch.float64)
        ref = _product(a, b, c0)
        _require(stack_kernel.launches > 0, "resilience: the clean product never took K1")

        def faulted(spec, what, failures, fallbacks, tol=1e-12, ops=(a, b, c0), want=ref):
            # a failover heals the cached plan: every product here plans
            # anew, and each case starts from closed breakers
            mm.clear_plan_cache()
            breaker.reset_board()
            metrics.reset()
            before = _counts()
            with faults.inject_faults(spec) as sp:
                c = _product(*ops)
            took = _launched_since(before)
            mm.clear_plan_cache()
            rel = _canvas_rel(c, want)
            _require(sp[0].fired == 1 and rel <= tol and took["plain"] == 0,
                     f"resilience {what}: fired {sp[0].fired}, rel {rel:.3e} > {tol:.1e}, "
                     f"launched {took}")
            return {"spec": spec, "rel": rel, "launched": took,
                    **_expect_counts(what, failures, fallbacks)}

        out["launch_failover"] = faulted("pallas:raise,times=1", "launch failover",
                                         {("pallas", "runtime"): 1},
                                         {("pallas", "pallas_cross"): 1})
        out["non_finite"] = faulted("execute_stack:nan,times=1", "non-finite output",
                                    {("pallas", "nan"): 1}, {("pallas", "pallas_cross"): 1})
        # the breaker: three failures open it, the next launch skips K1
        breaker.reset_board()
        metrics.reset()
        board = breaker.get_board()
        with faults.inject_faults("pallas:raise") as sp:
            for _ in range(3):
                mm.clear_plan_cache()
                _product(a, b, c0)
            state = board.state("pallas", key64)
            _require(state == breaker.OPEN, f"resilience breaker: {state} after 3 failures")
            calls, before = sp[0].calls, _counts()
            mm.clear_plan_cache()
            c = _product(a, b, c0)
            took = _launched_since(before)
            _require(sp[0].calls == calls and took["smm_stack"] == 0
                     and took["smm_crosspack"] > 0 and took["plain"] == 0,
                     f"resilience breaker: the quarantined product launched {took}")
        mm.clear_plan_cache()
        rel = _canvas_rel(c, ref)
        _require(rel <= 1e-12, f"resilience breaker: quarantined product rel {rel:.3e}")
        out["breaker"] = {"state_after_3": state, "board": board.snapshot(), "rel": rel,
                          "quarantined_launched": took,
                          **_expect_counts("breaker", {("pallas", "runtime"): 3},
                                           {("pallas", "pallas_cross"): 4})}
        breaker.reset_board()
        # the canvas failover on full operands
        full = _resilience_operands(torch.float64, occ=(1.0, 1.0, 0.3))
        set_config(mm_format="dense")
        ref_dense = _product(*full)
        _require(ref_dense._mm_algorithm == "dense", "resilience: the clean canvas leg ran "
                 f"{ref_dense._mm_algorithm}")
        out["canvas_failover"] = faulted("dense:raise,times=1", "canvas failover",
                                         {("dense", "runtime"): 1}, {("dense", "stack"): 1},
                                         ops=full, want=ref_dense)
        set_config(mm_format="stack")
        del full, ref_dense
        # the crosspack demotion, f32: a deterministic failure demotes the
        # shape, an out-of-memory one does not
        a32, b32, c32 = _resilience_operands(torch.float32)
        k3_before = crosspack_kernel.launches_cross
        ref32 = _product(a32, b32, c32)
        _require(crosspack_kernel.launches_cross > k3_before, "resilience: f32 never took K3")
        tol32 = kernel_validation_tolerance("float32", MODEL_BLOCK, MODEL_BLOCKS)
        demotion = {}
        for kind in ("raise", "oom"):
            port_smm._cross_disabled.discard(key32)
            demotion[kind] = faulted(f"pallas_cross:{kind},times=1", f"crosspack {kind}",
                                     {("pallas_cross", "oom" if kind == "oom" else "runtime"): 1},
                                     {("pallas_cross", "pallas"): 1}, tol=tol32,
                                     ops=(a32, b32, c32), want=ref32)
            demoted = key32 in port_smm._cross_disabled
            _require(demoted == (kind == "raise"),
                     f"resilience crosspack {kind}: demoted {demoted}")
            before = _counts()
            c = _product(a32, b32, c32)  # planned anew, without a fault
            took = _launched_since(before)
            want = "smm_stack" if demoted else "smm_crosspack"
            _require(took[want] > 0 and took["plain"] == 0,
                     f"resilience crosspack {kind}: the next product launched {took}")
            rel = _canvas_rel(c, ref32)
            _require(rel <= tol32, f"resilience crosspack {kind}: next product rel {rel:.3e}")
            demotion[kind].update(demoted=demoted, next_product=took, next_rel=rel)
        port_smm._cross_disabled.discard(key32)
        out["crosspack_demotion"] = demotion
        del a32, b32, c32, ref32
        # the host driver: CPU matrices on the card's host, against the
        # plain version; the same request on the card's tensors raises
        cpu = _resilience_operands(torch.float64, device="cpu")
        host = {}
        for driver in ("host", "torch", "host", "torch"):
            set_config(mm_driver=driver)
            c = cpu[2].copy()
            t0 = time.perf_counter()
            mm.multiply("N", "N", 0.7, cpu[0], cpu[1], 0.5, c)
            host.setdefault(driver, {"wall_s": [], "c": c})["wall_s"].append(
                time.perf_counter() - t0)
        rel = (maxabs_norm(added(host["host"]["c"], host["torch"]["c"], 1.0, -1.0))
               / maxabs_norm(host["torch"]["c"]))
        _require(rel <= 1e-12, f"resilience host driver vs torch: rel {rel:.3e}")
        set_config(mm_driver="host")
        mm.clear_plan_cache()
        try:
            mm.multiply("N", "N", 0.7, a, b, 0.5, c0.copy())
        except ValueError as exc:
            refused = str(exc)
        else:
            raise RuntimeError("resilience: mm_driver='host' ran on the card's tensors")
        out["host_driver"] = {"stacks": "cpu", "rel_to_torch": rel, "cuda_refused": refused,
                              "wall_s": {d: v["wall_s"] for d, v in host.items()}}
        set_config(mm_driver="auto")
        del cpu, host
        # one `.perf` gate with a failing K1 launch: the checksum holds
        cfg = parse_perf_file(os.path.join(INPUTS, "test_H2O.perf"))
        cfg.nrep = 1
        mm.clear_plan_cache()
        metrics.reset()
        before = _counts()
        with faults.inject_faults("pallas:raise,times=1") as sp:
            res = run_perf(cfg, verbose=False)  # raises PerfChecksumError on mismatch
        took = _launched_since(before)
        _require(took["plain"] == 0, f"resilience perf gate: launched {took}")
        out["perf_gate"] = {"input": "test_H2O", "checksum": res["checksum"], "fired":
                            sp[0].fired, "launched": took,
                            **_expect_counts("perf gate", {("pallas", "runtime"): 1},
                                             {("pallas", "pallas_cross"): 1})}
    finally:
        faults.clear()
        breaker.reset_board()
        mm.clear_plan_cache()
        port_smm._cross_disabled.discard(key32)
        set_config(mm_driver="auto", mm_format="auto", abft="off")
    counts = _counts()
    out["launches"] = counts
    _emit(out)
    return {"smm_stack": counts["smm_stack"], "smm_crosspack": counts["smm_crosspack"]}


def _probe_ms(a, b, c, reps: int = 5) -> dict:
    """Each stack of ``c = a * b`` timed by CUDA events beside its ABFT
    probe: the first-touch form (C was zero) and the delta form (a
    pristine copy of C subtracted), summed per multiply."""
    i, j, a_ent, b_ent = _candidates(a, b, None)
    spans = _build_spans(c, a, b, i * c.nblkcols + j, a_ent, b_ent)
    tot = {"stack_ms": 0.0, "probe_ms_c_zero": 0.0, "probe_ms_delta": 0.0, "spans": len(spans)}
    for sp in spans:
        ad, bd, cd = a.bins[sp.abin].data, b.bins[sp.bbin].data, c.bins[sp.cbin].data
        kernel, _ = _calls(sp.plan)
        scratch, base = cd.clone(), torch.zeros_like(cd)
        tot["stack_ms"] += _time_ms(lambda: kernel(scratch, ad, bd, 1.0), reps)
        tot["probe_ms_c_zero"] += _time_ms(
            lambda: abft.stack_probe(None, cd, ad, bd, sp.plan, 1.0, c_zero=True), reps)
        tot["probe_ms_delta"] += _time_ms(
            lambda: abft.stack_probe(base, cd, ad, bd, sp.plan, 1.0), reps)
        del scratch, base
    return tot


def _same_bits(x, y) -> bool:
    return np.array_equal(x.keys, y.keys) and all(
        bx.data.equal(by.data) for bx, by in zip(x.bins, y.bins))


# the silent flip of the integrity phase, and for each loop a flip its
# chain invariant catches in the same step at the models' size (ABFT
# off): purify's trace bound sees a diagonal element of its first
# product, the sign bound a flip in X' (the step's second product),
# invsqrt's residual contraction a flip in the second residual.
FLIP = "execute_stack:flip,seed=13,times=1"
# `FLIP` with ABFT off, as the JAX package's own guarded loops end at
# this size on the CPU (`tools/flip_reference.py --package jax`): purify
# misses the off-diagonal flip and runs on to a wrong iterate, sign sees
# it a step late, after accepting the iterate, and raises; invsqrt rolls
# it back.  (outcome, rollbacks), required of the port alike.
FLIP_OFF_REFERENCE = {"purify": ("differs", 0), "sign": ("ChainIntegrityError", 1),
                      "invsqrt": ("bitwise", 1)}
INVARIANT_FLIPS = {"purify": "execute_stack:flip@stack==1,seed=0,times=1",
                   "sign": "execute_stack:flip@stack==2,seed=13,times=1",
                   "invsqrt": "execute_stack:flip@stack==4,seed=13,times=1"}


def phase_integrity() -> dict:
    """The integrity plane on the models' operands (2208^2, f64): the
    three loops under ``abft="verify"`` bit for bit as without it, in
    turns; a silent flip caught by the chain invariant (ABFT off,
    `INVARIANT_FLIPS`) and by the probe (verify, `FLIP`), both ending bit
    for bit on the clean loop, and `FLIP` with ABFT off ending as the JAX
    package's loops end (`FLIP_OFF_REFERENCE`); a canvas flip in purify
    redone on the stack format; and the north star
    (f64, K1; f32, K3) under "verify" against "off" in turns, with the
    probe's milliseconds beside the stacks'.  Returns K1's and K3's
    launches."""
    p0 = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, occ=0.2, seed=MODEL_SEED)
    _, loops = _model_loops(p0, SIGN_STEPS, SIGN_EPS)
    out = {"phase": "integrity", "n": MODEL_BLOCKS * MODEL_BLOCK, "dtype": "float64"}
    _reset_counts()
    try:
        rows = {}
        for name, loop in loops.items():
            runs = {"off": [], "verify": []}
            for mode in ("off", "verify", "verify", "off"):
                set_config(abft=mode)
                metrics.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x, hist = loop()[:2]
                torch.cuda.synchronize()
                runs[mode].append((time.perf_counter() - t0, x, hist,
                                   _ctr("dbcsr_tpu_abft_checks_total")))
                took = {k: v for k, v in _integrity_counts().items() if v}
                _require(not took, f"integrity {name} ({mode}, no fault) took {took}")
            set_config(abft="off")
            x0, h0 = runs["off"][0][1:3]
            for mode, rs in runs.items():
                for _, x, h, _ in rs:
                    _require(list(h) == list(h0) and _same_bits(x, x0),
                             f"integrity {name}: a run under {mode} differs from the "
                             f"unguarded loop")
            row = {"wall_s": {m: [r[0] for r in rs] for m, rs in runs.items()},
                   "abft_checks": runs["verify"][0][3], "steps": len(h0)}
            # a silent flip: the chain invariant with ABFT off, on a launch
            # it catches at this size, and on the first launch (as the
            # reference ends); then the probe under "verify"
            for case, mode, spec in (("flip_off", "off", INVARIANT_FLIPS[name]),
                                     ("flip_off_first_launch", "off", FLIP),
                                     ("flip_verify", "verify", FLIP)):
                set_config(abft=mode)
                metrics.reset()
                outcome = None
                try:
                    with faults.inject_faults(spec) as sp:
                        x, h = loop()[:2]
                except (integrity.ChainIntegrityError, port_smm.CorruptedOutputError) as exc:
                    outcome = type(exc).__name__
                finally:
                    set_config(abft="off")
                    # a failover heals cached plans and feeds the breakers:
                    # the next run starts from neither
                    mm.clear_plan_cache()
                    breaker.reset_board()
                if outcome is None:
                    outcome = "bitwise" if (_same_bits(x, x0) and list(h) == list(h0)) \
                        else "differs"
                rollbacks = _ctr("dbcsr_tpu_chain_rollback_total")
                recov = _ctr("dbcsr_tpu_abft_recoveries_total")
                row[case] = {"spec": spec, "fired": sp[0].fired, "outcome": outcome,
                             "rollbacks": rollbacks, "abft_recoveries": recov,
                             "abft_mismatches": _ctr("dbcsr_tpu_abft_mismatches_total")}
                if case == "flip_off_first_launch":
                    want = FLIP_OFF_REFERENCE[name]
                    row[case]["reference"] = want
                    _require(sp[0].fired == 1 and (outcome, rollbacks) == want,
                             f"integrity {name} {case}: {row[case]}, the JAX package "
                             f"ends {want}")
                    continue
                detector = rollbacks if mode == "off" else recov
                _require(sp[0].fired == 1 and detector >= 1 and outcome == "bitwise"
                         and (mode == "off" or rollbacks == 0),
                         f"integrity {name} {case}: {row[case]}")
            rows[name] = row
            del runs
        # a canvas flip in purify: the canvas probe condemns it and the
        # product is redone on the stack format
        set_config(abft="verify")
        metrics.reset()
        with faults.inject_faults("dense:flip,times=1") as sp:
            x, h = loops["purify"]()
        set_config(abft="off")
        x0 = mcweeny_purify(p0, steps=PURIFY_STEPS)[0]
        rel = _iterate_diff(x, x0)
        _require(sp[0].fired == 1 and rel <= 1e-12
                 and _ctr("dbcsr_tpu_abft_mismatches_total", driver="dense") == 1
                 and _ctr("dbcsr_tpu_abft_recoveries_total", driver="dense") == 1
                 and _ctr("dbcsr_tpu_driver_fallback_total", **{"from": "dense",
                                                                "to": "stack"}) == 1,
                 f"integrity canvas flip: fired {sp[0].fired}, rel {rel:.3e}, "
                 f"{_integrity_counts()}")
        rows["purify"]["canvas_flip"] = {"rel": rel, **_integrity_counts()}
        out["loops"] = rows
        # the north star under "verify" against "off", in turns
        ns = {}
        for dtype_code, dname in ((3, "float64"), (1, "float32")):
            res = run_perf(_northstar_cfg(1, dtype_code), verbose=False)
            a, b = res["matrices"]["a"], res["matrices"]["b"]
            c_out = res["matrices"]["c_out"]
            empty = BlockSparseMatrix("C", c_out.row_blk_sizes, c_out.col_blk_sizes, c_out.dtype)
            walls = {"off": [], "verify": []}
            ref = None
            for mode in ("off", "verify", "verify", "off"):
                set_config(abft=mode)
                metrics.reset()
                for rep in range(3):
                    c = empty.copy()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    mm.multiply("N", "N", 1.0, a, b, 0.0, c)
                    torch.cuda.synchronize()
                    if rep:
                        walls[mode].append(time.perf_counter() - t0)
                took = {k: v for k, v in _integrity_counts().items() if v}
                _require(not took, f"integrity north star {dname} ({mode}) took {took}")
                if ref is None:
                    ref = c
                _require(_same_bits(c, ref), f"integrity north star {dname} ({mode}): C differs")
            set_config(abft="off")
            ns[dname] = {"s_per_multiply": walls, **_probe_ms(a, b, c_out)}
            del res, a, b, c_out, c, ref
        out["northstar"] = ns
    finally:
        faults.clear()
        breaker.reset_board()
        mm.clear_plan_cache()
        abft.discard_pending()
        set_config(abft="off", mm_driver="auto", mm_format="auto")
    counts = _counts()
    out["launches"] = counts
    _emit(out)
    return {"smm_stack": counts["smm_stack"], "smm_crosspack": counts["smm_crosspack"]}


# ----------------------------------------------------------------- complex
COMPLEX_NREP = 2


def _form_row(form: str, launches: int, timing: dict) -> dict:
    """One of K1's forms in the kernels line: its launches on the main
    path beside its stacks' times, error and bound (one `_stacks_phase`)."""
    return {"form": form, "launches": launches, "max_abs_err": timing["max_abs_err"][0],
            "ms": timing["ms"][0], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"], "library_ms": None}


def _forms_since_reset() -> dict:
    return dict(stack_kernel.launches_by_form)


def phase_complex() -> dict:
    """The north star's pattern (10,000^2, 23x23 blocks, occupancy 0.1) at
    complex128 and then complex64 through `run_perf`, on K1's complex form
    (its tiled path): no crosspack launch, no plain call; C against one
    repeat under ``"torch"`` (elementwise and checksums within 1e-10 at
    complex128, the kernel validation tolerance at complex64); the stacks
    by CUDA events beside their bound and the plain version's time; then
    C = alpha A B^H at `test_H2O`'s blocking (2208^2), ``transb="C"``,
    against the plain driver and a dense oracle on the card.  Returns
    K1's launches and its complex form rows."""
    out = {"phase": "complex", "northstar": {}}
    forms, launches = [], 0
    for data_type in (7, 5):
        dtype = dtype_of(data_type)
        dname = name_of(dtype)
        _reset_counts()
        res = run_perf(_northstar_cfg(COMPLEX_NREP, data_type), verbose=False)
        counts, by_form = _counts(), _forms_since_reset()
        _require(counts["smm_stack"] > 0 and counts["plain"] == 0
                 and counts["smm_crosspack"] == 0 and counts["smm_crosspack_resident"] == 0,
                 f"complex north star {dname}: launches {counts}")
        _require(set(by_form) == {dname}, f"complex north star {dname}: forms {by_form}")
        longest = max(s[5] for s in res["spans"])
        tol = 1e-10 if dtype == torch.complex128 else kernel_validation_tolerance(dname, 23,
                                                                                  longest)
        row = {"dtype": dname, "path": stack_kernel.kernel_path(23, 23, 23, dtype),
               **_run_summary(res, COMPLEX_NREP, counts), "launches_by_form": by_form,
               "longest_run": longest, "a_bytes": sum(x.data.numel() * x.data.element_size()
                                                      for x in res["matrices"]["a"].bins),
               "c_bytes": sum(x.data.numel() * x.data.element_size()
                              for x in res["matrices"]["c_out"].bins)}
        row.update(_against_torch_driver(res, _northstar_cfg(1, data_type), tol, tol))
        row.pop("spans")
        out["northstar"][dname] = row
        launches += counts["smm_stack"]
        operands = _operands(res, _northstar_cfg(1, data_type))
        del res
        timing = _stacks_phase(f"complex_{dname}_stacks", *operands, path="tiled")
        forms.append(_form_row(dname, counts["smm_stack"], timing))
        del operands
    # C = alpha A B^H at 2208^2, complex128
    a, b = _resilience_operands(torch.complex128, seed=20261019)[:2]
    c = BlockSparseMatrix("C", a.row_blk_sizes, b.row_blk_sizes, torch.complex128)
    alpha = 0.5 - 0.25j
    _reset_counts()
    mm.multiply("N", "C", alpha, a, b, 0.0, c)
    torch.cuda.synchronize()
    counts = _counts()
    _require(counts["smm_stack"] > 0 and counts["plain"] == 0, f"A B^H: launches {counts}")
    launches += counts["smm_stack"]
    set_config(mm_driver="torch")
    try:
        ref = BlockSparseMatrix("R", a.row_blk_sizes, b.row_blk_sizes, torch.complex128)
        mm.multiply("N", "C", alpha, a, b, 0.0, ref)
    finally:
        set_config(mm_driver="auto")
    oracle = alpha * (_to_dense_device(a) @ _to_dense_device(b).conj().T)
    rel_plain, rel_dense = _canvas_rel(c, ref), float(
        (_to_dense_device(c) - oracle).abs().max()) / float(oracle.abs().max())
    _require(rel_plain <= 1e-12 and rel_dense <= 1e-12,
             f"A B^H: rel {rel_plain:.3e} vs the plain driver, {rel_dense:.3e} vs dense")
    out["hermitian_product"] = {"n": MODEL_BLOCKS * MODEL_BLOCK, "transb": "C",
                                "alpha": [alpha.real, alpha.imag], "launches": counts,
                                "rel_plain_driver": rel_plain, "rel_dense_oracle": rel_dense,
                                "spans": c._mm_spans}
    out["forms"] = forms
    _emit(out)
    return {"launches": launches, "forms": forms}


# --------------------------------------------------------------- precision
# every demoted form of K1 and the data dtypes it takes
DEMOTED_FORMS = ((torch.float64, ("float32", False)), (torch.float64, ("float32", True)),
                 (torch.float64, ("bfloat16", False)), (torch.float64, ("bfloat16", True)),
                 (torch.float32, ("bfloat16", False)), (torch.float32, ("bfloat16", True)))
# one shape on each K1 path: the north star's (warp) and 100/50/20 (tiled)
DEMOTED_SHAPES = ((23, 23, 23), (100, 50, 20))


def _demoted_vs_plain() -> list:
    """Every demoted form on both K1 paths against its plain version on
    synthetic stacks (runs of 1-4 and one of 5000), timed: both round the
    same operands, so they agree within the rounding of the form's sums
    (`form_tolerance` at the stack's k and longest run), far inside the
    demotion ceiling."""
    rng = np.random.default_rng(20261020)
    alpha = -0.75
    cases, paths = [], set()
    for dtype, spec in DEMOTED_FORMS:
        for m, n, k in DEMOTED_SHAPES:
            a, b, c, a_idx, b_idx, c_idx = _synthetic_stack(rng, m, n, k, dtype)
            plan = prepare_stack(c, a, b, a_idx, b_idx, c_idx, variant="kmerge")
            args = (plan.a_idx, plan.b_idx, plan.run_ptr, plan.run_c)

            def kernel(c_, a_, b_, al, spec=spec, args=args):
                return stack_kernel.smm_stack(c_, a_, b_, *args, al, precision=spec)

            def plain(c_, a_, b_, al, spec=spec, args=args):
                return stack_kernel.smm_stack_plain(c_, a_, b_, *args, al, precision=spec)
            path = stack_kernel.kernel_path(m, n, k, dtype)
            paths.add(path)
            got = _written(kernel, c, a, b, alpha)
            want = plain(c.clone(), a, b, alpha)
            torch.cuda.synchronize()
            rel = _rel_err(got, want)
            tol = form_tolerance(name_of(dtype), spec, k, plan.max_run)
            _require(np.isfinite(rel) and rel <= tol,
                     f"demoted {spec} != plain for {dtype} {(m, n, k)} ({path} path): "
                     f"rel {rel:.3e} > {tol:.1e}")
            scratch = c.clone()
            bound, by = stack_bound_s(name_of(dtype), m, n, k, plan.entries,
                                      len(np.unique(a_idx)), len(np.unique(b_idx)), plan.nruns,
                                      precision=spec)
            cases.append({"form": stack_kernel.form_name(dtype, spec), "mnk": [m, n, k],
                          "path": path, "entries": plan.entries, "runs": plan.nruns,
                          "longest_run": plan.max_run, "max_rel_err": rel, "tolerance": tol,
                          "ms": _time_ms(lambda: kernel(scratch, a, b, alpha), 10),
                          "plain_ms": _time_ms(lambda: plain(scratch, a, b, alpha), 3),
                          "bound_ms": bound * 1e3, "bound_by": by})
            del a, b, c, got, want, scratch
    _require(paths == {"warp", "tiled"}, f"the demoted forms ran the paths {sorted(paths)}")
    return cases


def _demoted_counts() -> int:
    return int(_ctr("dbcsr_tpu_precision_launches_total"))


def _h2o_form(data_type: int, mode: str, column=None) -> tuple:
    """`test_H2O` at ``data_type`` under ``precision=mode`` (a tuned row's
    ``precision`` column where given) against its native run: checksums
    and C within the form's ceiling; returns (row, main-path launches by
    form, the stacks' timing)."""
    cfg = parse_perf_file(os.path.join(INPUTS, "test_H2O.perf"))
    cfg.data_type, cfg.nrep, cfg.check = data_type, 1, False
    native_res = run_perf(cfg, verbose=False)
    set_config(precision=mode, abft="verify" if mode == "adaptive" else "off")
    try:
        if column is not None:
            for m, n, k in _block_shapes(cfg):
                params.save_entry({"m": m, "n": n, "k": k, "dtype": name_of(dtype_of(data_type)),
                                   "driver": "pallas", "precision": column, "gflops": 0.0})
        _reset_counts()
        metrics.reset()
        res = run_perf(cfg, verbose=False)
        counts, by_form = _counts(), _forms_since_reset()
        timing = _stacks_phase(f"precision_h2o_{data_type}_{mode}_{column}_stacks",
                               *_operands(res, cfg))
    finally:
        set_config(precision="native", abft="off")
    spec = {"f32": ("float32", True), "bf16": ("bfloat16", True)}.get(mode) or \
        port_precision.column_spec(column, dtype_of(data_type))
    form = stack_kernel.form_name(dtype_of(data_type), spec)
    _require(set(by_form) == {form} and counts["plain"] == 0 and counts["smm_crosspack"] == 0,
             f"test_H2O {mode}/{column}: launches {counts}, forms {by_form}, want {form}")
    longest = max(s[5] for s in res["spans"])
    tol = demoted_abft_tolerance(name_of(dtype_of(data_type)), *spec, 23, longest)
    rel_cs = abs(res["checksum"] - native_res["checksum"]) / abs(native_res["checksum"])
    rel_el = _canvas_rel(res["matrices"]["c_out"], native_res["matrices"]["c_out"])
    _require(rel_cs <= tol and rel_el <= tol,
             f"test_H2O {form}: rel {rel_cs:.3e}/{rel_el:.3e} against native > {tol:.1e}")
    row = {"form": form, "mode": mode, "column": column, "launches": counts,
           "demoted_launches": _demoted_counts(), "times_s": res["times_s"],
           "native_times_s": native_res["times_s"], "rel_checksum": rel_cs,
           "rel_elementwise": rel_el, "tolerance": tol,
           "abft_mismatches": _ctr("dbcsr_tpu_abft_mismatches_total")}
    return row, by_form.get(form, 0), timing


def _sabotaged(fn):
    """``fn()`` with every demotion ceiling at 1e-30: each demoted probe
    breaches."""
    real = port_costmodel.demoted_abft_tolerance
    port_costmodel.demoted_abft_tolerance = lambda *args: 1e-30
    try:
        return fn()
    finally:
        port_costmodel.demoted_abft_tolerance = real


def phase_precision() -> dict:
    """The precision planner and K1's demoted forms: every form against its
    plain version on both paths; the f64 north star under
    ``precision="adaptive"``, ``abft="verify"`` (every stack demoted,
    every probe passing, C within the ceiling of the native product,
    seconds per multiply native and demoted in turns); the forced modes
    and the tuned ``precision`` column on `test_H2O`; a forced promote
    (the ceiling sabotaged for one product, beta = 0 and beta = 0.5):
    native re-execution bit for bit, the cell native afterwards; and the
    sign loop at the models' size under adaptive + verify, demoting,
    promoting and converging as the native loop does.  Returns K1's
    launches on the main path and its demoted form rows."""
    out = {"phase": "precision", "kernel_vs_plain": _demoted_vs_plain()}
    forms, launches = {}, 0
    port_precision.reset()
    # the f64 north star, native and adaptive, under verify
    cfg = _northstar_cfg(1)
    res = run_perf(cfg, verbose=False)
    a, b, c_nat = _operands(res, cfg)
    empty = BlockSparseMatrix("C", c_nat.row_blk_sizes, c_nat.col_blk_sizes, c_nat.dtype)
    del res
    set_config(abft="verify")
    try:
        walls = {"native": [], "adaptive": []}
        c_dem = None
        for mode in ("native", "adaptive", "adaptive", "native"):
            set_config(precision=mode)
            for rep in range(2):
                metrics.reset()
                _reset_counts()
                c = empty.copy()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mm.multiply("N", "N", 1.0, a, b, 0.0, c)
                torch.cuda.synchronize()
                walls[mode].append(time.perf_counter() - t0)
                if mode == "adaptive":
                    spans = len(c._mm_spans)
                    _require(_demoted_counts() == spans
                             and _ctr("dbcsr_tpu_abft_checks_total") >= spans
                             and not _ctr("dbcsr_tpu_abft_mismatches_total")
                             and not _ctr("dbcsr_tpu_precision_promotions_total"),
                             f"adaptive north star: {_demoted_counts()} demoted launches of "
                             f"{spans} stacks, {metrics.snapshot()}")
                    if c_dem is None:
                        c_dem, launches = c, stack_kernel.launches
                        forms["float64:float32"] = stack_kernel.launches_by_form.get(
                            "float64:float32", 0)
        longest = max(s[5] for s in c_dem._mm_spans)
        tol = demoted_abft_tolerance("float64", "float32", False, 23, longest)
        rel = _canvas_rel(c_dem, c_nat)
        _require(0 < rel <= tol, f"adaptive north star: rel {rel:.3e} to native, ceiling {tol:.1e}")
        cells = port_precision.cells_snapshot()
        _require(cells and all(i["state"] == "demoted" for i in cells.values()),
                 f"adaptive north star: cells {cells}")
        out["northstar"] = {"s_per_multiply": walls, "rel_to_native": rel, "ceiling": tol,
                            "spans": len(c_dem._mm_spans), "cells": {
                                "x".join(map(str, k)): v for k, v in cells.items()}}
        set_config(precision="adaptive")
        ns_timing = _stacks_phase("precision_northstar_stacks", a, b, c_dem)
    finally:
        set_config(precision="native", abft="off")
    del a, b, c_nat, c_dem, c, empty
    rows = [_form_row("float64:float32", forms["float64:float32"], ns_timing)]
    # the forced modes and the tuned column on test_H2O
    prev_dir = os.environ.get("DBCSR_TPU_TORCH_PARAMS_DIR")
    h2o = []
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["DBCSR_TPU_TORCH_PARAMS_DIR"] = tmp
        try:
            for data_type, mode, column in ((3, "f32", None), (3, "bf16", None),
                                            (1, "bf16", None), (3, "adaptive", "bf16"),
                                            (1, "adaptive", "bf16")):
                port_precision.reset()
                row, n, timing = _h2o_form(data_type, mode, column)
                h2o.append(row)
                rows.append(_form_row(row["form"], n, timing))
                launches += n
        finally:
            if prev_dir is None:
                os.environ.pop("DBCSR_TPU_TORCH_PARAMS_DIR", None)
            else:
                os.environ["DBCSR_TPU_TORCH_PARAMS_DIR"] = prev_dir
            params.invalidate()
    out["test_H2O"] = h2o
    # a forced promote at 2208^2: the deferred flush (beta 0) and the
    # immediate check (beta 0.5)
    promote = {}
    a, b, c0 = _resilience_operands(torch.float64, seed=20261021)
    for beta in (0.0, 0.5):
        port_precision.reset()
        want = _product(a, b, c0, beta=beta)
        set_config(precision="adaptive", abft="verify")
        try:
            metrics.reset()
            events.clear()
            got = _sabotaged(lambda: _product(a, b, c0, beta=beta))
            cells = port_precision.cells_snapshot()
            _require(_same_bits(got, want), f"forced promote (beta {beta}): C is not the native C")
            _require(cells and all(i["state"] == "promoted" for i in cells.values())
                     and port_precision.resolve(23, 23, 23, torch.float64) is None
                     and events.records(kind="precision_promote_reexec"),
                     f"forced promote (beta {beta}): cells {cells}")
            took = {k: v for k, v in _integrity_counts().items() if v}
            _require(not took, f"forced promote (beta {beta}) took the integrity plane: {took}")
            again = _product(a, b, c0, beta=beta)  # resolves native up front
            _require(_same_bits(again, want), "after the promote: C is not the native C")
            promote[f"beta_{beta}"] = {
                "promotions": _ctr("dbcsr_tpu_precision_promotions_total"),
                "reexecutions": len(events.records(kind="precision_promote_reexec")),
                "demoted_launches": _demoted_counts(), "bitwise_native": True}
        finally:
            set_config(precision="native", abft="off")
    out["forced_promote"] = promote
    del a, b, c0, want, got, again
    # the sign loop: native, then adaptive + verify
    p0 = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, occ=0.2, seed=MODEL_SEED)
    steps = 2 * SIGN_STEPS  # room to converge: the loops stop at their tolerance
    sign = {}
    for mode in ("native", "adaptive"):
        port_precision.reset()
        set_config(precision=mode, abft="verify" if mode == "adaptive" else "off")
        try:
            events.clear()
            metrics.reset()
            _, loops = _model_loops(p0, steps, SIGN_EPS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, hist = loops["sign"]()
            torch.cuda.synchronize()
            evs = events.records(kind="precision_schedule")
            sign[mode] = {"wall_s": time.perf_counter() - t0, "steps": len(hist),
                          "history": list(hist), "demoted_launches": _demoted_counts(),
                          "schedule": [e["precision"] for e in evs],
                          "promoted_at": [e["step"] for e in evs if e.get("promoted")],
                          "floor": evs[0]["floor"] if evs else None, "x": x}
        finally:
            set_config(precision="native", abft="off")
    nat, dem = sign["native"], sign["adaptive"]
    tol = 1e-10  # sign_iteration's tolerance, which the native loop reaches
    _require(nat["history"][-1] < tol, f"native sign loop ends {nat['history'][-1]:.3e}")
    _require(dem["schedule"] and dem["schedule"][0] == "demoted"
             and dem["schedule"][-1] == "native" and len(dem["promoted_at"]) == 1
             and dem["promoted_at"][0] < len(dem["schedule"]) and dem["demoted_launches"] > 0,
             f"adaptive sign loop: schedule {dem['schedule']}")
    _require(dem["history"][-1] < tol,
             f"sign loops: native ends {nat['history'][-1]:.3e}, adaptive "
             f"{dem['history'][-1]:.3e} (tolerance {tol:.3e})")
    sign["tolerance"] = tol
    sign["adaptive"]["iterate_rel_to_native"] = _iterate_diff(dem.pop("x"), nat.pop("x"))
    out["sign"] = sign
    out["forms"] = rows
    _emit(out)
    return {"launches": launches, "forms": rows}


# ------------------------------------------------------------- incremental
def _new_values(m, sel, rng) -> int:
    """New values, same pattern, in ``m``'s entries ``sel`` (a
    same-pattern finalize: the journal sees exactly those keys)."""
    r, col = m.entry_coords()
    m.put_blocks(r[sel], col[sel], [rng.standard_normal(m.block_shape(r[e], col[e]))
                                    for e in sel])
    m.finalize()
    return len(sel)


def _rows_delta(m, rows, rng) -> int:
    return _new_values(m, np.nonzero(np.isin(m.entry_coords()[0], rows))[0], rng)


def _blocks_delta(m, frac, rng) -> int:
    return _new_values(m, np.sort(rng.choice(m.nblks, max(1, int(frac * m.nblks)),
                                             replace=False)), rng)


def _inc_counts() -> dict:
    return {lab["result"]: v for lab, v in metrics.counter_items("dbcsr_tpu_incremental_total")}


def _incremental_leg(name: str, a, b, kernel: str) -> dict:
    """The incremental multiply on one product C = A B (beta 0): full
    products until the cache installs, a zero delta, a delta of one
    block row of A and deltas of 0.1%, 1% and 5% of A's blocks.  A delta
    is spliced, or recomputed in full when a splice at least as large
    lost to the full run (``fallback_costly``) or it dirties more than
    `mm.incremental`'s share of the product (``fallback_all_dirty``);
    either way C is bit for bit an ``incremental="full"`` run; each case
    timed against "full" in turns (auto, full, full, auto; a fresh delta
    before every run of a delta case), with the host's phases of each."""
    empty = BlockSparseMatrix("C", a.row_blk_sizes, b.col_blk_sizes, a.dtype)
    c = empty.copy()
    rng = np.random.default_rng(20261022)
    set_config(incremental="auto")
    port_inc.reset()
    _reset_counts()
    # the first product's key has C's empty pattern, the second's the
    # product's: its repeat, the third, installs
    for _ in range(3):
        mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    counts = _counts()
    _require(counts[kernel] > 0 and counts["plain"] == 0, f"incremental {name}: {counts}")
    launches = counts[kernel]
    _require(port_inc.cache_snapshot()["entries"] == 1, f"incremental {name}: nothing cached")
    row0 = int(a.keys[0] // a.nblkcols)
    cases = {"zero": lambda: 0, "row": lambda: _rows_delta(a, [row0], rng),
             "blocks_0.1pct": lambda: _blocks_delta(a, 0.001, rng),
             "blocks_1pct": lambda: _blocks_delta(a, 0.01, rng),
             "blocks_5pct": lambda: _blocks_delta(a, 0.05, rng)}
    out = {"c_bytes": port_inc.cache_snapshot()["bytes"],
           "max_recompute_fraction": port_inc._MAX_RECOMPUTE_FRACTION, "cases": {}}
    for case, delta in cases.items():
        walls = {"auto": [], "full": []}
        phases = {"auto": [], "full": []}
        info, outcomes = {}, []
        for mode in ("auto", "full", "full", "auto"):
            dirty = delta()
            set_config(incremental=mode)
            metrics.reset()
            _reset_counts()
            before = port_inc.stats_snapshot()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mm.multiply("N", "N", 1.0, a, b, 0.0, c)
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            phases[mode].append(dict(c._mm_phase_s))
            if mode == "auto":
                got = _inc_counts()
                wants = (("hit_unchanged",) if case == "zero"
                         else ("hit_splice", "fallback_costly", "fallback_all_dirty"))
                _require(sum(got.values()) == 1 and any(got.get(w) == 1 for w in wants),
                         f"incremental {name} {case}: outcomes {got}")
                outcomes.append(got)
                info = {"dirty_blocks": dirty, "outcomes": outcomes, "launches": _counts(),
                        "phase_s": dict(c._mm_phase_s), "reuse": port_inc.reuse_delta(before)}
                # the "full" rerun into a C of the same pattern: it keys and
                # refreshes the same cache entry (a C of another pattern
                # would install a second 396 MB entry and evict this one)
                set_config(incremental="full")
                ref = c.copy()
                mm.multiply("N", "N", 1.0, a, b, 0.0, ref)
                torch.cuda.synchronize()
                _require(_same_bits(c, ref),
                         f"incremental {name} {case}: the reuse is not bit for bit the full C")
                del ref
        info["s_per_multiply"] = walls
        info["host_phase_s"] = phases
        info["median_ratio_auto_to_full"] = float(np.median(walls["auto"])
                                                  / np.median(walls["full"]))
        out["cases"][case] = info
    set_config(incremental="off")
    out["totals"] = port_inc.stats_snapshot()
    out["launches"] = launches
    return out


def _models_under_default() -> dict:
    """The three DFT loops at 2208^2 through the planner under the
    default ``incremental="auto"`` against "off", in turns (off, auto,
    auto, off; the result cache emptied before each run): every run bit
    for bit the first, the reuse outcomes of the "auto" runs counted,
    seconds each."""
    p0 = make_test_density(MODEL_BLOCKS, MODEL_BLOCK, occ=0.2, seed=MODEL_SEED)
    _, loops = _model_loops(p0, SIGN_STEPS, SIGN_EPS)
    out = {}
    for name, loop in loops.items():
        walls = {"off": [], "auto": []}
        row = {"outcomes": {}, "reuse": {}}
        ref = None
        for mode in ("off", "auto", "auto", "off"):
            set_config(incremental=mode)
            port_inc.reset()
            metrics.reset()
            (x, hist, *_), info = _drive("auto", loop)
            walls[mode].append(info["wall_s"])
            if ref is None:
                ref = (x, hist)
            else:
                _require(hist == ref[1] and _same_bits(x, ref[0]),
                         f"models {name} under incremental={mode}: not bit for bit the off run")
            if mode == "auto":
                row["outcomes"] = _inc_counts()
                row["reuse"] = port_inc.stats_snapshot()
        set_config(incremental="off")
        row["wall_s"] = walls
        row["median_ratio_auto_to_off"] = float(np.median(walls["auto"])
                                                / np.median(walls["off"]))
        out[name] = row
        del ref, x
    return out


def phase_incremental() -> dict:
    """The delta-aware incremental multiply on the card: the f32 north star
    on K3 and a 2208^2 f64 product on K1 (`_incremental_leg`); at 2208^2
    also the full-product probe under ``abft="verify"`` and an
    ``incremental:flip`` fault, caught, counted and recomputed in full;
    and the f64 north star, whose C (792 MB) is over the 512 MB cache
    budget and is never cached; then the models' loops under the default
    ``incremental="auto"`` against "off" (`_models_under_default`).
    Returns K1's and K3's launches."""
    out = {"phase": "incremental", "cache_max_bytes": port_inc.cache_snapshot()["max_bytes"]}
    try:
        cfg = _northstar_cfg(1, data_type=1)
        res = run_perf(cfg, verbose=False)
        a, b, _ = _operands(res, cfg)
        del res
        out["northstar_f32"] = _incremental_leg("northstar_f32", a, b, "smm_crosspack")
        k3 = out["northstar_f32"]["launches"]
        del a, b
        a, b = _resilience_operands(torch.float64, seed=20261023)[:2]
        out["h2o_f64"] = _incremental_leg("h2o_f64", a, b, "smm_stack")
        k1 = out["h2o_f64"]["launches"]
        # the full-product probe, clean and under a flip
        set_config(incremental="auto", abft="verify")
        c = BlockSparseMatrix("C", a.row_blk_sizes, b.col_blk_sizes, a.dtype)
        rng = np.random.default_rng(20261024)
        for _ in range(3):
            mm.multiply("N", "N", 1.0, a, b, 0.0, c)
        # the probe cases need their splices to run: forget the leg's
        # verdicts on what a splice of this product costs
        port_inc._lost_at.clear()
        _rows_delta(a, [1], rng)
        metrics.reset()
        mm.multiply("N", "N", 1.0, a, b, 0.0, c)
        clean = {"outcomes": _inc_counts(),
                 "checks": _ctr("dbcsr_tpu_abft_checks_total", driver="incremental")}
        _require(clean["outcomes"].get("hit_splice") == 1 and clean["checks"] == 1
                 and not _ctr("dbcsr_tpu_abft_mismatches_total"),
                 f"incremental probe: {clean}")
        port_inc._lost_at.clear()
        _rows_delta(a, [2], rng)
        metrics.reset()
        with faults.inject_faults("incremental:flip,times=1") as sp:
            mm.multiply("N", "N", 1.0, a, b, 0.0, c)
        set_config(incremental="full")
        ref = BlockSparseMatrix("R", a.row_blk_sizes, b.col_blk_sizes, a.dtype)
        mm.multiply("N", "N", 1.0, a, b, 0.0, ref)
        torch.cuda.synchronize()
        flip = {"fired": sp[0].fired, "outcomes": _inc_counts(),
                "mismatches": _ctr("dbcsr_tpu_abft_mismatches_total", driver="incremental"),
                "recoveries": _ctr("dbcsr_tpu_abft_recoveries_total", driver="incremental")}
        _require(sp[0].fired == 1 and flip["outcomes"].get("fallback_abft") == 1
                 and flip["mismatches"] == 1 and flip["recoveries"] == 1
                 and _same_bits(c, ref), f"incremental flip: {flip}")
        _require(not _ctr("dbcsr_tpu_driver_failures_total")
                 and not _ctr("dbcsr_tpu_driver_fallback_total"),
                 "incremental flip: a stack driver failed")
        out["h2o_f64"]["probe"] = {"clean": clean, "flip": flip}
        del a, b, c, ref
        # the f64 north star: never cached
        set_config(incremental="auto", abft="off")
        port_inc.reset()
        cfg = _northstar_cfg(1)
        res = run_perf(cfg, verbose=False)
        a, b, c_out = _operands(res, cfg)
        c_bytes = sum(x.data.numel() * x.data.element_size() for x in c_out.bins)
        del res, c_out
        metrics.reset()
        for _ in range(3):
            c = BlockSparseMatrix("C", a.row_blk_sizes, b.col_blk_sizes, a.dtype)
            mm.multiply("N", "N", 1.0, a, b, 0.0, c)
            del c
        snap = port_inc.cache_snapshot()
        _require(snap["entries"] == 0 and c_bytes > snap["max_bytes"]
                 and port_inc.stats_snapshot()["products"] == 0,
                 f"f64 north star: {snap}, C {c_bytes} B")
        out["northstar_f64"] = {"c_bytes": c_bytes, "cache": snap, "outcomes": _inc_counts(),
                                "note": "C exceeds the cache budget: never cached, "
                                        "every repeat recomputes"}
        del a, b
        out["models_default"] = _models_under_default()
    finally:
        faults.clear()
        breaker.reset_board()
        mm.clear_plan_cache()
        port_inc.reset()
        set_config(incremental="off", abft="off")
    _emit(out)
    return {"smm_stack": k1, "smm_crosspack": k3}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; "
              "this script runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        return 2
    # the engine's phases time the engine: the incremental multiply is
    # off but in its own phase, as in the perf driver's repeats
    set_config(mm_driver="auto", validate_kernels=True, incremental="off")
    # every phase but resilience, integrity and incremental injects
    # nothing, so each must end without a failover, a fallback, an ABFT
    # mismatch or a rollback (`_clean`)
    _clean("build", phase_build)
    _clean("kernel_vs_plain", phase_kernel_vs_plain)
    _clean("crosspack_vs_plain", phase_crosspack_vs_plain)
    _clean("perf_gates", phase_perf_gates, "auto")
    _clean("perf_gates_crosspack", phase_perf_gates, "pallas_cross")
    ns = _clean("northstar", phase_northstar)
    _clean("native_index", phase_native_index, ns["a"], ns["b"], ns["c"])
    k1 = _kernel_row("smm_stack", ns.pop("launches"), _clean(
        "northstar_stacks", _stacks_phase, "northstar_stacks", ns.pop("a"), ns.pop("b"),
        ns.pop("c")))
    k3 = _clean("northstar_f32", phase_northstar_f32)
    k4 = _clean("resident_f32", phase_resident_f32)
    k1["launches_by_path"] = {"northstar": k1["launches"],
                              "formats": _clean("formats", phase_formats),
                              "limits": _clean("limits", phase_limits),
                              "models": _clean("models", phase_models)}
    k3["launches_by_path"] = {"northstar_f32": k3["launches"],
                              "models_f32": _clean("models_f32", phase_models_f32)}
    # the legs first: they validate K1 at (529, 23, 23) for f64 and f32,
    # so the full-width run's stack times hold no first-use check
    k1["launches_by_path"]["tensor_legs"] = _clean("tensor_legs", phase_tensor_legs)
    tensor = _clean("tensor", phase_tensor)
    k1["launches_by_path"]["tensor"] = tensor.pop("launches")
    k1["by_path"] = {"tensor": {**tensor, "library_ms": None}}
    # K1's complex and demoted forms, each beside its launches on its
    # phase's main path
    cx = _clean("complex", phase_complex)
    pr = _clean("precision", phase_precision)
    k1["launches_by_path"]["complex"] = cx["launches"]
    k1["launches_by_path"]["precision"] = pr["launches"]
    k1["forms"] = cx["forms"] + pr["forms"]
    for phase, fn in (("resilience", phase_resilience), ("integrity", phase_integrity),
                      ("incremental", phase_incremental)):
        launched = fn()
        k1["launches_by_path"][phase] = launched["smm_stack"]
        k3["launches_by_path"][phase] = launched["smm_crosspack"]
    k4["launches_by_path"] = {"resident_f32": k4["launches"]}
    print(json.dumps({"kernels": [k1, k3, k4]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
