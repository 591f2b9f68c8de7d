"""The control of a cell's check: the plain reference in the program's
place, computed in the precision just below the configuration's
(float32 for float64, TF32 off; bfloat16 for float32; complex64 for
complex128), and judged by the cell's own limits.
A sound check reads the control as not correct.

    python3 -m portbench.control --workload ns_f64.scf --seeds 11 12 13

From the root of a checkout, on the card (``--device cpu`` for a small
configuration).  Prints one JSON line a seed with each number beside
its limit; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench import harness
from portbench.reference import blocksparse as ref

LOWER = {"float64": torch.float32, "float32": torch.bfloat16,
         "complex128": torch.complex64}


def low_answer(a, b, c0, alpha, beta, device, low) -> tuple:
    """The reference product computed in ``low``, as an answer under
    judgement: (shape groups [((bm, bn), sorted keys, slots, data)], all
    keys sorted), the form `ref.compare` takes a program's C in."""
    nc = len(b.col_sizes)
    col_off = ref.offsets(b.col_sizes)
    parts: dict = {}
    for rows, c, keys in ref.product_chunks(a, b, c0, alpha, beta, low, device):
        rows_map = np.full(len(a.row_sizes), -1, np.int64)
        rows_map[rows] = ref.offsets(a.row_sizes[rows])[:-1]
        shapes = a.row_sizes[keys // nc] << 32 | b.col_sizes[keys % nc]
        for code in np.unique(shapes):
            shape = (int(code >> 32), int(code & 0xFFFFFFFF))
            k = keys[shapes == code]
            parts.setdefault(shape, []).append(
                (k, ref.gather_blocks(c, k, nc, rows_map, col_off, shape)))
        del c
    got = []
    for shape, chunks in sorted(parts.items()):
        keys = np.concatenate([k for k, _ in chunks])
        order = np.argsort(keys, kind="stable")
        data = torch.cat([d for _, d in chunks])
        got.append((shape, keys[order], order.astype(np.int64), data))
    all_keys = np.sort(np.concatenate([g[1] for g in got])) if got else np.empty(0, np.int64)
    return got, all_keys


def readings(cell: str, seed: int, device, pb_dir: str = harness.PB_DIR) -> dict:
    """The control's numbers on the operands of a cell's first window
    step, judged by `ref.compare` as the program's answer is, each with
    its limit: {name: (value, limit)}."""
    wl, cfg, kind = harness.load_cell(cell, pb_dir)
    device = torch.device(device)
    ops = kind.Inputs(cfg, seed, device).operands(0)
    got, keys = low_answer(*ops, device, LOWER[cfg["dtype"]])
    r = ref.compare(got, keys, *ops, device)
    r["norm_rel_err"] = ref.norm_rel_err(ref.groups_norm2(got), r["norm2"])
    return {k: (r[k], lim) for k, lim in wl["params"]["limits"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        got = readings(args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fails": any(v > lim for v, lim in got.values()),
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in got.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
