#!/usr/bin/env python3
"""On-card smoke test of dbcsr_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA stack kernel from ``dbcsr_tpu_torch/csrc`` with nvcc,
then runs five phases, each printing one JSON line; any failure raises
and the script exits non-zero:

1. card and build: the card's name and power limit, CUDA version,
   nvcc seconds and ptxas resource lines;
2. the stack kernel against its plain PyTorch version on the card, for
   f64/f32/bf16 at block shapes (23,23,23), (23,18,23), (18,23,18),
   (5,13,23), (100,50,20), on stacks with short runs, one run of 5000
   entries, alpha != 1 and a nonzero incoming C;
3. `.perf` checksum gates through `run_perf` (the kernel must launch,
   the plain version must not run);
4. the north-star product (10k x 10k, 23x23 blocks, occupancy 0.1, f64,
   beta 0, 3 repeats) through the kernel, held against one repeat with
   ``mm_driver="torch"`` (the plain version) at rel <= 1e-10;
5. the kernel and the plain version compared and timed on the north
   star's own stacks, with the least time the card could take for them.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits 2 and prints
no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

from dbcsr_tpu_torch.acc import build, stack_kernel
from dbcsr_tpu_torch.core.config import set_config
from dbcsr_tpu_torch.device import resolve_device
from dbcsr_tpu_torch.mm.multiply import _build_spans, _candidates
from dbcsr_tpu_torch.obs.costmodel import kernel_validation_tolerance, stack_bytes
from dbcsr_tpu_torch.perf.driver import parse_perf_file, run_perf

ROOT = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(ROOT, "tests", "inputs")

# NVIDIA H100 SXM data sheet, dense rates: HBM3 bandwidth, and the peak
# for each operand type (f64: FP64 tensor cores; f32: CUDA cores; bf16:
# tensor cores), at the full 700 W power limit
H100_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12,
                   torch.bfloat16: 989e12}

KERNEL_SOURCE = "dbcsr_tpu_torch/csrc/smm_stack.cu"
KERNEL_REPLACES = "dbcsr_tpu/acc/pallas_smm.py:132"


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _bound_s(dtype, m, n, k, entries, n_a, n_b, nruns) -> tuple:
    """Least time for one stack on the card: each referenced A and B
    block read once, the index arrays read once, each C block of a run
    read and written once, against the flops over the type's peak."""
    isz = torch.empty(0, dtype=dtype).element_size()
    nbytes = (isz * (n_a * m * k + n_b * k * n + 2 * nruns * m * n)
              + 4 * (2 * entries + 2 * nruns + 1))
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2.0 * m * n * k * entries / H100_PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


def _stack_args(plan):
    return plan.a_idx, plan.b_idx, plan.run_ptr, plan.run_c


def phase_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    build.build_all([stack_kernel.SOURCE])
    log = build.build_logs.get(stack_kernel.SOURCE, "")
    _emit({"phase": "build", "card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0),
           "nvcc_s": build.build_seconds[stack_kernel.SOURCE],
           "ptxas": [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "Compiling entry" in ln]})
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


def phase_kernel_vs_plain() -> None:
    from dbcsr_tpu_torch.acc.smm import prepare_stack

    rng = np.random.default_rng(20261016)
    alpha = -0.75
    cases = []
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for m, n, k in ((23, 23, 23), (23, 18, 23), (18, 23, 18), (5, 13, 23),
                        (100, 50, 20)):
            a, b, c, a_idx, b_idx, c_idx = _synthetic_stack(rng, m, n, k, dtype)
            plan = prepare_stack(c, a, b, a_idx, b_idx, c_idx)
            args = _stack_args(plan)
            got = stack_kernel.smm_stack(c.clone(), a, b, *args, alpha)
            want = stack_kernel.smm_stack_plain(c.clone(), a, b, *args, alpha)
            torch.cuda.synchronize()
            diff = float((got.double() - want.double()).abs().max())
            rel = diff / max(float(want.double().abs().max()), 1.0)
            tol = kernel_validation_tolerance(str(dtype).replace("torch.", ""),
                                              k, plan.max_run)
            _require(np.isfinite(rel) and rel <= tol,
                     f"kernel != plain for {dtype} {(m, n, k)}: rel {rel:.3e} > {tol:.1e}")
            scratch = c.clone()
            ms = _time_ms(lambda: stack_kernel.smm_stack(scratch, a, b, *args, alpha), 10)
            plain_ms = _time_ms(
                lambda: stack_kernel.smm_stack_plain(scratch, a, b, *args, alpha), 3)
            bound, by = _bound_s(dtype, m, n, k, plan.entries,
                                 len(np.unique(a_idx)), len(np.unique(b_idx)), plan.nruns)
            cases.append({"dtype": str(dtype).replace("torch.", ""), "mnk": [m, n, k],
                          "entries": plan.entries, "runs": plan.nruns,
                          "longest_run": plan.max_run, "max_rel_err": rel,
                          "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound * 1e3, "bound_by": by})
    _emit({"phase": "kernel_vs_plain", "alpha": alpha,
           "library_ms": None,
           "library_note": "no single PyTorch call computes this function",
           "cases": cases})


PERF_GATES = (("test_H2O", 3), ("test_square_sparse", 1), ("test_rect1_sparse", 1),
              ("test_rect2_sparse", 1), ("test_singleblock", 1),
              ("test_square_sparse_bigblocks", 1))


def phase_perf_gates() -> None:
    rows = []
    for name, nrep in PERF_GATES:
        cfg = parse_perf_file(os.path.join(INPUTS, f"{name}.perf"))
        cfg.nrep = nrep
        stack_kernel.reset_counts()
        res = run_perf(cfg, verbose=False)  # raises PerfChecksumError on mismatch
        launches, plain = stack_kernel.launches, stack_kernel.plain_calls
        _require(launches > 0, f"{name}: the stack kernel never launched")
        _require(plain == 0, f"{name}: the plain version ran {plain} times")
        rows.append({"input": name, "nrep": nrep, "checksum": res["checksum"],
                     "checksum_pos": res["checksum_pos"],
                     "refs": list(cfg.check_refs), "threshold": cfg.check_threshold,
                     "launches": launches, "times_s": res["times_s"],
                     "gflops_best": res["gflops_best"]})
    _emit({"phase": "perf_gates", "passed": len(rows), "inputs": rows})


def _northstar_cfg(nrep: int):
    cfg = parse_perf_file(os.path.join(INPUTS, "northstar.perf"))
    cfg.beta = 0.0  # as bench.py runs it
    cfg.nrep = nrep
    return cfg


def phase_northstar() -> dict:
    stack_kernel.reset_counts()
    res = run_perf(_northstar_cfg(3), verbose=False)
    launches, plain = stack_kernel.launches, stack_kernel.plain_calls
    _require(launches > 0, "north star: the stack kernel never launched")
    _require(plain == 0, f"north star: the plain version ran {plain} times")
    mats = res["matrices"]
    c_out = mats["c_out"]

    set_config(mm_driver="torch")
    try:
        ref = run_perf(_northstar_cfg(1), verbose=False)
    finally:
        set_config(mm_driver="auto")
    c_ref = ref["matrices"]["c_out"]
    _require(np.array_equal(c_out.keys, c_ref.keys), "north star: C patterns differ")
    rel_cs = abs(res["checksum"] - ref["checksum"]) / abs(ref["checksum"])
    rel_pos = abs(res["checksum_pos"] - ref["checksum_pos"]) / abs(ref["checksum_pos"])
    scale = max(float(b.data.abs().max()) for b in c_ref.bins)
    rel_el = max(float((x.data - y.data).abs().max())
                 for x, y in zip(c_out.bins, c_ref.bins)) / scale
    _require(rel_cs <= 1e-10 and rel_pos <= 1e-10 and rel_el <= 1e-10,
             f"north star: kernel vs torch driver rel {rel_cs:.3e}/{rel_pos:.3e}/"
             f"{rel_el:.3e} > 1e-10")
    _emit({"phase": "northstar", "shape": [10000, 10000, 10000], "block": 23,
           "occupancy": 0.1, "dtype": "float64", "nrep": 3,
           "times_s": res["times_s"], "host_s": res["host_s"],
           "host_phase_s": res["host_phase_s"],
           "stack_device_s": res["stack_device_s"], "flops": res["flops"],
           "gflops_true": [res["flops"] / t / 1e9 for t in res["times_s"]],
           "launches": launches, "launches_per_multiply": launches / 3,
           "checksum": res["checksum"], "checksum_pos": res["checksum_pos"],
           "torch_driver_checksum": ref["checksum"],
           "torch_driver_checksum_pos": ref["checksum_pos"],
           "torch_driver_times_s": ref["times_s"],
           "rel_checksum": rel_cs, "rel_checksum_pos": rel_pos,
           "rel_elementwise": rel_el, "tolerance": 1e-10,
           "c_blocks": int(c_out.nblks)})
    return {"launches": launches, "a": mats["a"], "b": mats["b"], "c": c_out}


def phase_northstar_stacks(ns: dict) -> dict:
    """The kernel and its plain version on the north star's own stacks,
    re-planned from the product's operands; times summed per multiply."""
    a, b, c = ns["a"], ns["b"], ns["c"]
    i, j, a_ent, b_ent = _candidates(a, b, None)
    spans = _build_spans(c, a, b, i * c.nblkcols + j, a_ent, b_ent)
    alpha = 1.0
    rows, tot_ms, tot_plain, tot_bound, max_err = [], 0.0, 0.0, 0.0, 0.0
    modeled_bytes = 0
    for cbin, abin, bbin, m, n, k, entries, plan in spans:
        ad, bd, cd = a.bins[abin].data, b.bins[bbin].data, c.bins[cbin].data
        args = _stack_args(plan)
        got = stack_kernel.smm_stack(cd.clone(), ad, bd, *args, alpha)
        want = stack_kernel.smm_stack_plain(cd.clone(), ad, bd, *args, alpha)
        err = float((got - want).abs().max())
        del got, want
        scratch = cd.clone()
        ms = _time_ms(lambda: stack_kernel.smm_stack(scratch, ad, bd, *args, alpha), 5)
        plain_ms = _time_ms(
            lambda: stack_kernel.smm_stack_plain(scratch, ad, bd, *args, alpha), 2)
        del scratch
        a_used = len(torch.unique(plan.a_idx))
        b_used = len(torch.unique(plan.b_idx))
        bound, by = _bound_s(cd.dtype, m, n, k, entries, a_used, b_used, plan.nruns)
        modeled_bytes += stack_bytes(m, n, k, entries, nseg=plan.nruns, itemsize=8)
        rows.append({"mnk": [m, n, k], "entries": entries, "runs": plan.nruns,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound * 1e3,
                     "bound_by": by, "max_abs_err": err})
        tot_ms += ms
        tot_plain += plain_ms
        tot_bound += bound * 1e3
        max_err = max(max_err, err)
    flops = sum(2 * r["mnk"][0] * r["mnk"][1] * r["mnk"][2] * r["entries"] for r in rows)
    _emit({"phase": "northstar_stacks", "spans": rows, "launches_per_multiply": len(rows),
           "ms": tot_ms, "plain_ms": tot_plain, "bound_ms": tot_bound,
           "kernel_gflops": flops / tot_ms / 1e6, "flops": flops,
           "modeled_stack_bytes": modeled_bytes, "max_abs_err": max_err})
    return {"ms": tot_ms, "plain_ms": tot_plain, "bound_ms": tot_bound,
            "max_abs_err": max_err,
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
            else "operations"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; "
              "this script runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        return 2
    set_config(mm_driver="auto", validate_kernels=True)
    phase_build()
    phase_kernel_vs_plain()
    phase_perf_gates()
    ns = phase_northstar()
    timing = phase_northstar_stacks(ns)
    print(json.dumps({"kernels": [{
        "name": "smm_stack", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": ns["launches"],
        "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
