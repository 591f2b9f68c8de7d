"""A/B timings of variants of the warp-path kernels on the north star.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m dbcsr_tpu_torch.perf.kernel_ab [--tiles 16,32,64,128] [variant ...]

Each variant is the committed ``csrc/`` with a few text substitutions
(`VARIANTS`), built by nvcc into a temporary directory beside the
committed sources ("base").  K1 is timed on every stack of the f64 north
star (10k^2, 23x23 blocks, occupancy 0.1) and K3 on every stack of the
f32 one, each variant in turns, twice; a time is the sum over the stacks
of the mean of 10 launches (CUDA events).  ``--tiles`` also times K1 with
the runs of each stack walked in square tiles of C blocks of each width
(0: the stack's own order, row by row), after checking that the order
leaves C bit for bit equal.  One JSON line per timing.
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

from dbcsr_tpu_torch.acc import build
from dbcsr_tpu_torch.core.config import set_config
from dbcsr_tpu_torch.mm.multiply import _build_spans, _candidates, _effective
from dbcsr_tpu_torch.perf.driver import parse_perf_file, run_perf

NORTHSTAR = os.path.join(os.path.dirname(build.PKG_DIR), "tests", "inputs", "northstar.perf")

_STAGE = ("const int oa = stage_flat(slot, a + (int64_t)av * mk, mk, lane);\n"
          "      const int ob = stage_flat(slot + g.a_area, b + (int64_t)bv * kn, kn, lane);")
_MMA = ("acc.mma(buf + j * g.slot + o[0], buf + j * g.slot + g.a_area + o[1], "
        "g, n, k, lane);")
_CREG = "creg[i] = w < mn ? load_acc(cblk_p + w) : S(0);"
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
    "no_products": [("smm_warp.cuh", _MMA, "(void)o;")],
    "no_copies": [("smm_warp.cuh", _STAGE, "const int oa = av & 1, ob = bv & 1;")],
    # C read at the end of a run instead of into registers at its start
    "c_at_end": [("smm_warp.cuh", _CREG, "creg[i] = S(0);"),
                 ("smm_warp.cuh", "store_acc(cblk_p + w, creg[i] + alpha",
                  "store_acc(cblk_p + w, load_acc(cblk_p + w) + alpha")],
    # K1 blocks taking one contiguous share of the groups instead of grid-stride
    "k1_shares": [("smm_warp.cuh", _GRID_STRIDE,
                   "    const int share = ((nruns + nw - 1) / nw + gridDim.x - 1) / gridDim.x;\n"
                   "    if (i >= share) return -1;\n"
                   "    const int run = (blockIdx.x * share + i) * nw + w;")],
    # f32/bf16: B read in 8-byte pairs (the row's alignment is warp-uniform)
    "b_pairs": [("smm_warp.cuh", _B_SCALAR, _B_PAIRS)],
    # three K1 blocks an SM (at most 170 registers) instead of two
    "k1_3_blocks": [("smm_stack.cu", "__launch_bounds__(W * 32, 1)",
                     "__launch_bounds__(W * 32, MAXT < 4 ? 3 : 1)")],
    # three or eight runs a K1 block
    "k1_w3": [("smm_stack.cu", "constexpr int W = 4;", "constexpr int W = 3;")],
    "k1_w8": [("smm_stack.cu", "constexpr int W = 4;", "constexpr int W = 8;")],
    # 16-byte pieces bypassing L1
    "cg16": [("smm_warp.cuh", "    cp_async<16>(dst + head + i * q, src + head + i * q);",
              '    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::'
              '"r"(smem_addr(dst + head + i * q)), "l"(src + head + i * q) : "memory");')],
}

_I, _V = ctypes.c_int, ctypes.c_void_p


def build_variant(subs) -> dict:
    """{source: CDLL} of csrc/ with ``subs`` applied, built in a temporary
    directory (both sources at once)."""
    d = tempfile.mkdtemp(prefix="kernel_ab_")
    for f in os.listdir(build.CSRC_DIR):
        shutil.copy(os.path.join(build.CSRC_DIR, f), d)
    for fname, old, new in subs:
        path = os.path.join(d, fname)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise ValueError(f"{fname} has no {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    procs = {src: subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(d, src + ".so"),
         os.path.join(d, src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in build.SOURCES}
    libs = {}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        libs[src] = ctypes.CDLL(os.path.join(d, src + ".so"))
    return libs


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


def launcher(lib: dict, sp, a, b, c, plan_arrays=None):
    """A no-argument call of the span's kernel from ``lib`` on scratch C
    (K1 with ``plan_arrays`` = (a_idx, b_idx, run_ptr, run_c) overrides
    the plan's runs); returns (call, scratch)."""
    ad, bd = a.bins[sp.abin].data, b.bins[sp.bbin].data
    scratch = c.bins[sp.cbin].data.clone()
    p, st = sp.plan, torch.cuda.current_stream().cuda_stream
    dt = {torch.float64: 0, torch.float32: 1}[scratch.dtype]
    if p.driver == "crosspack":
        f = lib["smm_crosspack.cu"].smm_crosspack_launch
        f.argtypes = [_I] + [_V] * 8 + [_I] * 6 + [ctypes.c_double, _V]
        args = (dt, ad.data_ptr(), bd.data_ptr(), scratch.data_ptr(), p.a_idx.data_ptr(),
                p.b_idx.data_ptr(), p.run_ptr.data_ptr(), p.run_c.data_ptr(),
                p.pack_runs.data_ptr(), p.pack_runs.numel() // p.pack[0], p.pack[0],
                p.pack[1], sp.m, sp.n, sp.k, 1.0, st)
    else:
        f = lib["smm_stack.cu"].smm_stack_launch
        f.argtypes = [_I] + [_V] * 7 + [_I] * 4 + [ctypes.c_double, _V]
        ai, bi, rp, rc = plan_arrays or (p.a_idx, p.b_idx, p.run_ptr, p.run_c)
        args = (dt, ad.data_ptr(), bd.data_ptr(), scratch.data_ptr(), ai.data_ptr(),
                bi.data_ptr(), rp.data_ptr(), rc.data_ptr(), rc.numel(), sp.m, sp.n, sp.k,
                1.0, st)

    def call(keep=(scratch, plan_arrays)):  # the tensors behind the pointers
        err = f(*args)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call, scratch


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
    args = ap.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    set_config(mm_driver="auto", validate_kernels=False)
    names = ["base", *args.variants]
    libs = {name: build_variant(VARIANTS.get(name, [])) for name in names}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    for data_type, what in ((3, "K1 f64 north star"), (1, "K3 f32 north star")):
        a, b, c, spans = northstar_stacks(data_type)
        for name in names * 2:
            calls = [launcher(libs[name], sp, a, b, c)[0] for sp in spans]
            ms = sum(time_ms(call) for call in calls)
            print(json.dumps({"what": what, "variant": name, "ms": ms, "card": card}), flush=True)
        if data_type == 3 and args.tiles:
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
