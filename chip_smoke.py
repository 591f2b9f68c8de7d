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

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 2 and prints
no result.
"""

from __future__ import annotations

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
from dbcsr_tpu_torch.acc import build, crosspack_kernel, params, stack_kernel
from dbcsr_tpu_torch.acc.crosspack import choose_pack, resident_limit_bytes
from dbcsr_tpu_torch.acc.smm import prepare_stack
from dbcsr_tpu_torch.core import mempool
from dbcsr_tpu_torch.core.config import set_config
from dbcsr_tpu_torch.core.kinds import name_of
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.device import resolve_device
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.mm.multiply import (
    _build_spans,
    _candidates,
    _candidates_numpy,
    _effective,
    _to_dense_device,
)
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
from dbcsr_tpu_torch.obs.costmodel import (
    crosspack_entries,
    kernel_validation_tolerance,
    H100_BYTES_PER_S,
    H100_PEAK_FLOPS,
    stack_bound_s,
    stack_bytes,
    stack_min_bytes,
)
from dbcsr_tpu_torch.perf.driver import expand_block_sizes, parse_perf_file, run_perf

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
    version as ``f(c, a, b, alpha)``; ``resident`` overrides a crosspack
    plan's launch."""
    if plan.driver != "crosspack":
        args = (plan.a_idx, plan.b_idx, plan.run_ptr, plan.run_c)
        return (lambda c, a, b, al: stack_kernel.smm_stack(c, a, b, *args, al),
                lambda c, a, b, al: stack_kernel.smm_stack_plain(c, a, b, *args, al))
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


def _rel_err(got, want) -> float:
    diff = float((got.double() - want.double()).abs().max())
    return diff / max(float(want.double().abs().max()), 1.0)


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
    rel_el = max(float((x.data.double() - y.data.double()).abs().max())
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


def _stacks_phase(phase: str, a, b, c, kernels=(None,), reps=5) -> dict:
    """Each stack of the product ``c = a * b``, re-planned from its
    operands (every one must take its kernel's warp path), run through
    its plan's kernel (``kernels``: None for the
    plan's own launch, False/True to force a crosspack plan's plain or
    resident launch) and its plain version: compared, and timed by CUDA
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
        path = (crosspack_kernel.kernel_path(cd.dtype, plan.pack, sp.m, sp.n, sp.k)
                if plan.driver == "crosspack" else stack_kernel.kernel_path(sp.m, sp.n, sp.k))
        _require(path == "warp", f"{phase}: the {(sp.m, sp.n, sp.k)} span took the {path} path")
        row = {"mnk": [sp.m, sp.n, sp.k], "entries": sp.entries, "runs": plan.nruns,
               "kernel": sp.driver, "path": path, "ms": [], "max_abs_err": []}
        if plan.driver == "crosspack":
            row["pack"] = list(plan.pack)
            row["entry_slots"] = crosspack_entries(plan)
        for ki, resident in enumerate(kernels):
            kernel, _ = _calls(plan, resident=resident)
            got = kernel(cd.clone(), ad, bd, alpha)
            err = float((got.double() - want.double()).abs().max())
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
        bound, by = stack_bound_s(*counts)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; "
              "this script runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        return 2
    set_config(mm_driver="auto", validate_kernels=True)
    phase_build()
    phase_kernel_vs_plain()
    phase_crosspack_vs_plain()
    phase_perf_gates("auto")
    phase_perf_gates("pallas_cross")
    ns = phase_northstar()
    phase_native_index(ns["a"], ns["b"], ns["c"])
    k1 = _kernel_row("smm_stack", ns.pop("launches"),
                     _stacks_phase("northstar_stacks", ns.pop("a"), ns.pop("b"), ns.pop("c")))
    k3 = phase_northstar_f32()
    k4 = phase_resident_f32()
    k1["launches_by_path"] = {"northstar": k1["launches"], "formats": phase_formats(),
                              "limits": phase_limits(), "models": phase_models()}
    k3["launches_by_path"] = {"northstar_f32": k3["launches"], "models_f32": phase_models_f32()}
    k4["launches_by_path"] = {"resident_f32": k4["launches"]}
    print(json.dumps({"kernels": [k1, k3, k4]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
