"""A/B timings of variants of the stack kernels.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m dbcsr_tpu_torch.perf.kernel_ab [--tiles 16,32,64,128] [--forms] [variant ...]
    python3 -m dbcsr_tpu_torch.perf.kernel_ab --tiled [--forms] --fused

Each variant is the committed ``csrc/`` with a few text substitutions
(`VARIANTS`), built by nvcc into a temporary directory beside the
committed sources ("base").  Plans follow the untuned rules (an empty
parameter directory).  K1 is timed on every stack of the f64 north
star (10k^2, 23x23 blocks, occupancy 0.1) and K3 on every stack of the
f32 one, each variant in turns, twice; a time is the sum over the stacks
of the mean of 10 launches (CUDA events); ``--forms`` times K1's
f64->f32, c8 and c4 forms on their north stars too.  ``--tiles`` also times K1 with
the runs of each stack walked in square tiles of C blocks of each width
(0: the stack's own order, row by row), after checking that the order
leaves C bit for bit equal.  One JSON line per timing.

``--tiled`` times K1's tiled path on a synthetic stack of the RI
contraction's shape, (529,23,23) blocks at 3 to 6 entries a run (4.5 on
average; the contraction's own runs average 4.9; `TILED_STACK`), f64
and f32 (with ``--forms`` also every complex and demoted form,
`TILED_FORMS`): whole, without its products
("tiled_no_products") and without its operand copies
("tiled_no_copies"), each line beside the form's bound.  ``--fused`` does the same for K1's fused launch on
the fused bins of `mixed_blocks.perf` (f64 and f32; "fused_no_products",
"fused_no_copies").  Each mode builds K1 alone, every variant at once.

``--against [NAME=]DIR`` (repeatable) also builds the kernels of the
checkout at DIR (named NAME, "parent" by default) and times them in the
same turns, in every mode.  ``--edit "NAME:FILE:OLD=>NEW"``
(repeatable) adds a variant NAME: csrc/FILE with the text OLD replaced
by NEW (all of one NAME's edits together), for a one-off experiment
that needs no entry in `VARIANTS`; in ``--tiled``/``--fused`` mode it
goes to the mode its name starts with ("tiled_", "fused_").
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from dbcsr_tpu_torch.acc import build, params
from dbcsr_tpu_torch.core.config import set_config
from dbcsr_tpu_torch.mm.multiply import _build_spans, _candidates, _effective
from dbcsr_tpu_torch.perf.driver import parse_perf_file, run_perf

NORTHSTAR = os.path.join(os.path.dirname(build.PKG_DIR), "tests", "inputs", "northstar.perf")

_STAGE = ("const int oa = stage_flat(slot, a + (int64_t)av * mk, mk, lane);\n"
          "      const int ob = stage_flat(slot + a_area, b + (int64_t)bv * kn, kn, lane);")
_MMA = ("        if constexpr (SEG) {\n"
        "          if (gu.mt == MAXT && gu.nt == MAXT)\n"
        "            acc.template mma<true>(as, bs, gu, n, ku, lane);\n"
        "          else\n"
        "            acc.mma(as, bs, gu, n, ku, lane);\n"
        "        } else {\n"
        "          acc.entry(as, bs, gu, m, n, ku, lane, planes);\n"
        "        }")
_CREG = "creg[i] = w < mn ? load_acc(cblk_p + w) : S(0);"
_TILED_MMA = "acc.mma(src, kd, g.wr, s, lane);"
_TILED_STAGE = ("stage_flat(area, ap, Z * rv * k, tid);\n"
                "      stage_flat(area + g.a_area, bp, Z * k * n, tid);")
_GRID_STRIDE = "    const int run = (blockIdx.x + i * gridDim.x) * nw + w;"
_B_SCALAR = ("#pragma unroll\n"
             "      for (int j = 0; j < 2 * MAXT; ++j) bf[j] = j < tn ? bp[kk * n + j] : 0.0f;\n")
_B_PAIRS = (
    "      // B in 8-byte pairs: the lanes' columns differ by an even count, so\n"
    "      // the row's alignment is the same for the whole warp\n"
    '      const float* brow = bp + kk * n;\n'
    '      if ((reinterpret_cast<uintptr_t>(brow) & 7) == 0) {\n'
    '#pragma unroll\n'
    '        for (int j = 0; j < MAXT; ++j) {\n'
    '          float2 x = make_float2(0.0f, 0.0f);\n'
    '          if (j < g.nt) x = *reinterpret_cast<const float2*>(brow + 2 * j);\n'
    '          bf[2 * j] = x.x;\n'
    '          bf[2 * j + 1] = x.y;\n'
    '        }\n'
    '      } else {  // one float, pairs from the next, one float last\n'
    '        bf[0] = brow[0];\n'
    '#pragma unroll\n'
    '        for (int j = 0; j < MAXT - 1; ++j) {\n'
    '          float2 x = make_float2(0.0f, 0.0f);\n'
    '          if (j < g.nt - 1) x = *reinterpret_cast<const float2*>(brow + 1 + 2 * j);\n'
    '          bf[2 * j + 1] = x.x;\n'
    '          bf[2 * j + 2] = x.y;\n'
    '        }\n'
    '        bf[2 * MAXT - 1] = 0.0f;\n'
    '#pragma unroll\n'
    '        for (int j = 1; j < 2 * MAXT; j += 2)\n'
    '          if (j == tn - 1) bf[j] = brow[j];\n'
    '      }\n'
)

# name -> [(source file, text, replacement)]
VARIANTS = {
    # what bounds the kernels: no products, or no operand copies
    "no_products": [("smm_warp.cuh", _MMA, "        (void)as;\n        (void)bs;")],
    "no_copies": [("smm_warp.cuh", _STAGE, "const int oa = av & 1, ob = bv & 1;")],
    # the same for every form: c8's 16-byte fragment loads need offset 0
    "no_copies_aligned": [("smm_warp.cuh", _STAGE,
                           "(void)av;\n      (void)bv;\n      const int oa = 0, ob = 0;")],
    # C read at the end of a run instead of into registers at its start
    "c_at_end": [("smm_warp.cuh", _CREG, "creg[i] = S(0);"),
                 ("smm_warp.cuh", "const S cv = CPRE ? creg[CPRE ? i : 0] : load_acc(cblk_p + w);",
                  "const S cv = load_acc(cblk_p + w);")],
    # K1 blocks taking one contiguous share of the groups instead of grid-stride
    "k1_shares": [("smm_warp.cuh", _GRID_STRIDE,
                   "    const int share = ((nruns + nw - 1) / nw + gridDim.x - 1) / gridDim.x;\n"
                   "    if (i >= share) return -1;\n"
                   "    const int run = (blockIdx.x * share + i) * nw + w;")],
    # f32/bf16: B read in 8-byte pairs (the row's alignment is warp-uniform)
    "b_pairs": [("smm_warp.cuh", _B_SCALAR, _B_PAIRS)],
    # three K1 blocks an SM (at most 170 registers) instead of two
    "k1_3_blocks": [("smm_stack.cu", "__launch_bounds__(WN * 32, 1)",
                     "__launch_bounds__(WN * 32, MAXT < 4 ? 3 : 1)")],
    # three or eight runs a K1 block
    "k1_w3": [("smm_stack.cu", "constexpr int W = 4;", "constexpr int W = 3;")],
    "k1_w8": [("smm_stack.cu", "constexpr int W = 4;", "constexpr int W = 8;")],
    # 16-byte pieces bypassing L1
    "cg16": [("smm_warp.cuh", "    cp_async<16>(dst + head + i * q, src + head + i * q);",
              '    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::'
              '"r"(smem_addr(dst + head + i * q)), "l"(src + head + i * q) : "memory");')],
    # what bounds the tiled path (whole entries staged flat): no products,
    # or no operand copies
    "tiled_no_products": [("smm_stack.cu", _TILED_MMA, "(void)src;\n    (void)kd;")],
    "tiled_no_copies": [("smm_stack.cu", _TILED_STAGE, "(void)rv;\n      (void)ap;\n      (void)bp;")],
}
# the fused warp kernel runs the warp path's body (smm_warp.cuh)
VARIANTS["fused_no_products"] = VARIANTS["no_products"]
VARIANTS["fused_no_copies"] = VARIANTS["no_copies"]
TILED_VARIANTS = ("tiled_no_products", "tiled_no_copies")
FUSED_VARIANTS = ("fused_no_products", "fused_no_copies")
# the synthetic stack of --tiled: (m, n, k), operand blocks, C blocks, and
# run lengths drawn from 3..6 (4.5 entries a run on average; the RI
# contraction's 943,698 products over 190,965 C blocks make 4.9)
TILED_STACK = ((529, 23, 23), 4000, 400, 40000, (3, 7))
# the tiled forms of --tiled --forms besides native f64 and f32: complex
# c8 and c4, then every demoted (data dtype, precision spec) pair
TILED_FORMS = ((torch.complex128, None), (torch.complex64, None),
               (torch.float64, ("float32", False)), (torch.float64, ("float32", True)),
               (torch.float64, ("bfloat16", False)), (torch.float64, ("bfloat16", True)),
               (torch.float32, ("bfloat16", False)), (torch.float32, ("bfloat16", True)))

_I, _V = ctypes.c_int, ctypes.c_void_p


def _start_variant(subs, sources=build.SOURCES, csrc_dir=build.CSRC_DIR):
    """``csrc_dir`` (csrc/) with ``subs`` applied in a temporary
    directory, and its nvcc processes started (one a source):
    (directory, {source: process})."""
    d = tempfile.mkdtemp(prefix="kernel_ab_")
    for f in os.listdir(csrc_dir):
        shutil.copy(os.path.join(csrc_dir, f), d)
    for fname, old, new in subs:
        path = os.path.join(d, fname)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise ValueError(f"{fname} has no {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return d, {src: subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(d, src + ".so"),
         os.path.join(d, src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in sources}


def _finish_variant(started) -> dict:
    d, procs = started
    libs = {}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        libs[src] = ctypes.CDLL(os.path.join(d, src + ".so"))
    return libs


def build_variants(names, sources=build.SOURCES, trees=None, edits=None) -> dict:
    """{name: {source: CDLL}} of csrc/ with each variant's substitutions
    applied ("base": none; ``edits``: {name: substitutions} besides
    `VARIANTS`) and of each other checkout's csrc/ (``trees``: {name:
    checkout root}), every nvcc started at once."""
    table = {**VARIANTS, **(edits or {})}
    started = {name: _start_variant(table.get(name, []), sources) for name in names}
    for name, root in (trees or {}).items():
        started[name] = _start_variant([], sources,
                                       os.path.join(root, "dbcsr_tpu_torch", "csrc"))
    return {name: _finish_variant(st) for name, st in started.items()}


def build_variant(subs) -> dict:
    """{source: CDLL} of csrc/ with ``subs`` applied, built in a temporary
    directory (both sources at once)."""
    return _finish_variant(_start_variant(subs))


def northstar_stacks(data_type: int):
    """op(A), op(B), C and the spans of one north-star multiply."""
    cfg = parse_perf_file(NORTHSTAR)
    cfg.beta, cfg.nrep, cfg.data_type, cfg.check = 0.0, 1, data_type, False
    res = run_perf(cfg, verbose=False)
    mats = res["matrices"]
    a, b, c = (_effective(mats["a"], cfg.transa), _effective(mats["b"], cfg.transb),
               mats["c_out"])
    i, j, a_ent, b_ent = _candidates(a, b, None)
    return a, b, c, _build_spans(c, a, b, i * c.nblkcols + j, a_ent, b_ent)


def time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def launcher(lib: dict, sp, a, b, c, plan_arrays=None, compute: int = 0):
    """A no-argument call of the span's kernel from ``lib`` on scratch C
    (K1 with ``plan_arrays`` = (a_idx, b_idx, run_ptr, run_c) overrides
    the plan's runs, ``compute`` picks a demoted form as
    `stack_kernel.compute_code` numbers them); returns (call, scratch)."""
    ad, bd = a.bins[sp.abin].data, b.bins[sp.bbin].data
    scratch = c.bins[sp.cbin].data.clone()
    p, st = sp.plan, torch.cuda.current_stream().cuda_stream
    dt = {torch.float64: 0, torch.float32: 1, torch.complex64: 3,
          torch.complex128: 4}[scratch.dtype]
    if p.driver == "crosspack":
        f = lib["smm_crosspack.cu"].smm_crosspack_launch
        f.argtypes = [_I] + [_V] * 8 + [_I] * 6 + [ctypes.c_double, _V]
        args = (dt, ad.data_ptr(), bd.data_ptr(), scratch.data_ptr(), p.a_idx.data_ptr(),
                p.b_idx.data_ptr(), p.run_ptr.data_ptr(), p.run_c.data_ptr(),
                p.pack_runs.data_ptr(), p.pack_runs.numel() // p.pack[0], p.pack[0],
                p.pack[1], sp.m, sp.n, sp.k, 1.0, st)
    else:
        f = lib["smm_stack.cu"].smm_stack_launch
        f.argtypes = [_I, _I] + [_V] * 7 + [_I] * 4 + [ctypes.c_double] * 2 + [_V]
        ai, bi, rp, rc = plan_arrays or (p.a_idx, p.b_idx, p.run_ptr, p.run_c)
        args = (dt, compute, ad.data_ptr(), bd.data_ptr(), scratch.data_ptr(), ai.data_ptr(),
                bi.data_ptr(), rp.data_ptr(), rc.data_ptr(), rc.numel(), sp.m, sp.n, sp.k,
                1.0, 0.0, st)

    def call(keep=(scratch, plan_arrays)):  # the tensors behind the pointers
        err = f(*args)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call, scratch


def _k1_launch(lib, dt: int, a, b, c, plan, alpha: float = 1.0, compute: int = 0):
    """A no-argument launch of K1 from ``lib`` on the plan's stack (the
    form ``compute``, numbered as `stack_kernel.compute_code` numbers it),
    raising on a CUDA error."""
    f = lib["smm_stack.cu"].smm_stack_launch
    f.argtypes = [_I, _I] + [_V] * 7 + [_I] * 4 + [ctypes.c_double] * 2 + [_V]
    m, k = a.shape[1:]
    args = (dt, compute, a.data_ptr(), b.data_ptr(), c.data_ptr(), plan.a_idx.data_ptr(),
            plan.b_idx.data_ptr(), plan.run_ptr.data_ptr(), plan.run_c.data_ptr(),
            plan.run_c.numel(), m, b.shape[2], k, alpha, 0.0,
            torch.cuda.current_stream().cuda_stream)

    def call(keep=(a, b, c, plan)):  # the tensors behind the pointers
        err = f(*args)
        if err:
            raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    return call


def tiled_stack(dtype):
    """The --tiled stack: operands drawn from a fixed seed on the card,
    C zero, the plan of K1 (runs in C order, A blocks in a block row's
    order within a run)."""
    from dbcsr_tpu_torch.acc.smm import prepare_stack

    (m, n, k), na, nb, nc, (lo, hi) = TILED_STACK
    rng = np.random.default_rng(20261021)

    def values(shape):  # complex data: the imaginary parts drawn after the real ones
        x = rng.standard_normal(shape)
        return torch.from_numpy(x + 1j * rng.standard_normal(shape) if dtype.is_complex
                                else x).to("cuda", dtype)
    a, b = values((na, m, k)), values((nb, k, n))
    c = torch.zeros((nc, m, n), dtype=dtype, device="cuda")
    c_idx = np.repeat(np.arange(nc), rng.integers(lo, hi, size=nc))
    # a C block row shares its A blocks: run r reads A blocks near r's row
    a_idx = (c_idx // 10 * 7 + rng.integers(0, 7, size=len(c_idx))) % na
    b_idx = rng.integers(0, nb, size=len(c_idx))
    plan = prepare_stack(c, a, b, a_idx, b_idx, c_idx, variant="kmerge")
    return a, b, c, plan


def time_tiled(libs: dict, card: str, forms: bool = False) -> None:
    """--tiled: each variant on the synthetic stack, in turns, twice, for
    native f64 and f32 and, with ``forms``, every form of `TILED_FORMS`."""
    from dbcsr_tpu_torch.acc import stack_kernel
    from dbcsr_tpu_torch.obs.costmodel import stack_bound_s

    cases = ((torch.float64, None), (torch.float32, None)) + (TILED_FORMS if forms else ())
    for dtype, spec in cases:
        a, b, c, plan = tiled_stack(dtype)
        (m, n, k) = TILED_STACK[0]
        dname = str(dtype).replace("torch.", "")
        form = stack_kernel.form_name(dtype, spec)
        dt, compute = stack_kernel._DTYPE_CODE[dtype], stack_kernel.compute_code(dtype, spec)
        bound, by = stack_bound_s(dname, m, n, k, plan.entries,
                                  len(torch.unique(plan.a_idx)), len(torch.unique(plan.b_idx)),
                                  plan.nruns, precision=spec)
        for name in list(libs) * 2:
            ms = time_ms(_k1_launch(libs[name], dt, a, b, c, plan, compute=compute), 5)
            print(json.dumps({"what": f"K1 tiled {form} {m}x{n}x{k}", "form": form,
                              "variant": name, "ms": ms, "entries": plan.entries,
                              "runs": plan.nruns, "bound_ms": bound * 1e3, "bound_by": by,
                              "card": card}), flush=True)
        del a, b, c, plan


def fused_bins(data_type: int):
    """The fused bins of one `mixed_blocks.perf` multiply: for each C bin
    of several spans, (C bin data, spans' (A, B, a_idx, b_idx, k), merged
    run table)."""
    from dbcsr_tpu_torch.acc import smm as port_smm

    cfg = parse_perf_file(os.path.join(os.path.dirname(NORTHSTAR), "mixed_blocks.perf"))
    cfg.nrep, cfg.data_type, cfg.check = 1, data_type, False
    set_config(mm_driver="pallas")
    try:
        res = run_perf(cfg, verbose=False)
        mats = res["matrices"]
        a, b, c = mats["a"], mats["b"], mats["c_out"]
        i, j, a_ent, b_ent = _candidates(a, b, None)
        spans = _build_spans(c, a, b, i * c.nblkcols + j, a_ent, b_ent)
        out = []
        for cbin in sorted({sp.cbin for sp in spans}):
            group = [sp for sp in spans if sp.cbin == cbin]
            if len(group) < 2:
                continue
            cd = c.bins[cbin].data
            splan = port_smm.prepare_superstack([sp.plan for sp in group],
                                                [(sp.m, sp.n, sp.k) for sp in group], cd)
            out.append((cd, [(a.bins[sp.abin].data, b.bins[sp.bbin].data, sp.plan.a_idx,
                              sp.plan.b_idx, sp.k) for sp in group], splan.table))
    finally:
        set_config(mm_driver="auto")
    return out


def _fused_launch(lib, dt: int, cd, spans, table):
    """A no-argument fused launch of one bin from ``lib``, on scratch C."""
    f = lib["smm_stack.cu"].smm_superstack_launch
    ptrs = ctypes.POINTER(ctypes.c_longlong)
    f.argtypes = [_I, _I, ptrs, ptrs, ptrs, ptrs, ctypes.POINTER(_I)] + [_V] * 6 + \
        [_I, _I, _I, ctypes.c_double, _V]
    scratch = torch.zeros_like(cd)

    def host(vals, ctype):
        return (ctype * len(vals))(*vals)
    args = (dt, len(spans), host([x[0].data_ptr() for x in spans], ctypes.c_longlong),
            host([x[1].data_ptr() for x in spans], ctypes.c_longlong),
            host([x[2].data_ptr() for x in spans], ctypes.c_longlong),
            host([x[3].data_ptr() for x in spans], ctypes.c_longlong),
            host([x[4] for x in spans], _I), scratch.data_ptr(),
            *(t.data_ptr() for t in table), table[4].numel(), cd.shape[1], cd.shape[2], 1.0,
            torch.cuda.current_stream().cuda_stream)

    def call(keep=(scratch, spans, table)):
        err = f(*args)
        if err:
            raise RuntimeError(f"fused launch failed: CUDA error {err}")
    return call


def time_fused(libs: dict, card: str) -> None:
    """--fused: each variant on every fused bin of `mixed_blocks.perf`
    (the sum over the bins of each bin's mean of 10 launches), in turns,
    twice; and once under `torch.profiler` (the kernels' own time)."""
    for data_type, dt, dname in ((3, 0, "float64"), (1, 1, "float32")):
        bins = fused_bins(data_type)
        for name in libs:  # each variant's instances: registers, spills, blocks an SM
            f = getattr(libs[name]["smm_stack.cu"], "smm_superstack_attrs", None)
            if f is None:
                continue
            inst = set()
            for cd, spans, _ in bins:
                ks = (_I * len(spans))(*[x[4] for x in spans])
                out = (_I * 5)()
                if f(dt, len(spans), ks, cd.shape[1], cd.shape[2], out) == 0:
                    inst.add((out[0], out[1], out[4]))
            print(json.dumps({"what": f"K1 fused instances {dname}", "variant": name,
                              "registers_spill_blocks": sorted(inst)}), flush=True)
        for name in list(libs) * 2:
            calls = [_fused_launch(libs[name], dt, *x) for x in bins]
            ms = sum(time_ms(call) for call in calls)
            acts = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for call in calls:
                    call()
                torch.cuda.synchronize()
            device_ms = sum(getattr(e, "self_device_time_total", 0.0)
                            for e in prof.key_averages() if "superstack" in e.key) / 1e3
            print(json.dumps({"what": f"K1 fused mixed_blocks {dname}", "variant": name,
                              "bins": len(bins), "ms": ms, "device_ms": device_ms,
                              "card": card}), flush=True)
        del bins


def tiled_runs(sp, c, width: int):
    """The span's K1 runs reordered into square tiles of ``width`` C
    blocks (row-major tiles, row-major inside a tile)."""
    p = sp.plan
    run_ptr, run_c = p.run_ptr.cpu().numpy(), p.run_c.cpu().numpy()
    ents = np.nonzero(c.ent_bin == sp.cbin)[0]
    rows, cols = np.divmod(c.keys[ents], c.nblkcols)
    slot_row = np.empty(len(ents), np.int64)
    slot_col = np.empty(len(ents), np.int64)
    slot_row[c.ent_slot[ents]], slot_col[c.ent_slot[ents]] = rows, cols
    r, cc = slot_row[run_c], slot_col[run_c]
    ntiles = -(-c.nblkcols // width)
    order = np.lexsort((cc, r, (r // width) * ntiles + cc // width))
    sel = np.concatenate([np.arange(run_ptr[o], run_ptr[o + 1]) for o in order])
    new_ptr = np.concatenate([[0], np.cumsum(np.diff(run_ptr)[order])])
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(p.a_idx.device)
    return (up(p.a_idx.cpu().numpy()[sel]), up(p.b_idx.cpu().numpy()[sel]), up(new_ptr),
            up(run_c[order]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help=f"any of {', '.join(VARIANTS)}")
    ap.add_argument("--tiles", default="", help="tile widths for K1's work order, e.g. 16,64")
    ap.add_argument("--forms", action="store_true",
                    help="also K1's f64->f32, c8 and c4 forms on their north stars; with "
                         "--tiled, every tiled complex and demoted form (TILED_FORMS)")
    ap.add_argument("--tiled", action="store_true",
                    help="only K1's tiled path on TILED_STACK: whole, without products, "
                         "without copies")
    ap.add_argument("--fused", action="store_true",
                    help="only K1's fused launch on mixed_blocks: whole, without products, "
                         "without copies")
    ap.add_argument("--against", action="append", default=[], metavar="[NAME=]DIR",
                    help="also time this checkout's kernels (NAME, default 'parent')")
    ap.add_argument("--edit", action="append", default=[], metavar="NAME:FILE:OLD=>NEW",
                    help="a variant NAME: csrc/FILE with OLD replaced by NEW")
    args = ap.parse_args(argv)
    edits: dict = {}
    for e in args.edit:
        parts = e.split(":", 2)
        if len(parts) != 3 or "=>" not in parts[2]:
            ap.error(f"--edit wants NAME:FILE:OLD=>NEW, got {e!r}")
        old, new = parts[2].split("=>", 1)
        edits.setdefault(parts[0], []).append((parts[1], old, new))
    trees = dict(x.split("=", 1) if "=" in x else ("parent", x) for x in args.against)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    extra_names = list(trees)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    set_config(mm_driver="auto", validate_kernels=False)
    # plan on the untuned rules, as the smoke's kernel phases do: the
    # committed table sends f64 23^3 to K3
    os.environ["DBCSR_TPU_TORCH_PARAMS_DIR"] = tempfile.mkdtemp(prefix="kernel_ab_params_")
    params.invalidate()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    if args.tiled or args.fused:
        # the variants named besides go to the mode their prefix names
        named = (*args.variants, *edits)
        tiled = (*TILED_VARIANTS, *(v for v in named if v.startswith("tiled_")))
        fused = (*FUSED_VARIANTS, *(v for v in named if v.startswith("fused_")))
        names = ["base", *(tiled if args.tiled else ()), *(fused if args.fused else ())]
        libs = build_variants(names, sources=("smm_stack.cu",), trees=trees, edits=edits)
        if args.tiled:
            time_tiled({n: libs[n] for n in (*extra_names, "base", *tiled)}, card, args.forms)
        if args.fused:
            time_fused({n: libs[n] for n in (*extra_names, "base", *fused)}, card)
        return 0
    names = ["base", *args.variants, *edits]
    libs = build_variants(names, trees=trees, edits=edits)
    names = [*extra_names, *names]
    cases = [(3, "K1 f64 north star", 0)]
    if args.forms:
        cases += [(3, "K1 f64->f32 north star", 1), (7, "K1 c8 north star", 0),
                  (5, "K1 c4 north star", 0)]
    for data_type, what, compute in cases + [(1, "K3 f32 north star", 0)]:
        a, b, c, spans = northstar_stacks(data_type)
        for name in names * 2:
            calls = [launcher(libs[name], sp, a, b, c, compute=compute)[0] for sp in spans]
            ms = sum(time_ms(call) for call in calls)
            print(json.dumps({"what": what, "variant": name, "ms": ms, "card": card}), flush=True)
        if what == "K1 f64 north star" and args.tiles:
            widths = [0] + [int(w) for w in args.tiles.split(",")]
            for width in widths * 2:
                ms = 0.0
                for sp in spans:
                    order = tiled_runs(sp, c, width) if width else None
                    call, got = launcher(libs["base"], sp, a, b, c, order)
                    ref_call, want = launcher(libs["base"], sp, a, b, c)
                    call()
                    ref_call()
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise RuntimeError(f"tile width {width} changed C")
                    ms += time_ms(call)
                print(json.dumps({"what": "K1 f64 north star, runs in C tiles",
                                  "tile_width": width, "ms": ms, "card": card}), flush=True)
        del a, b, c, spans
    return 0


if __name__ == "__main__":
    sys.exit(main())
