"""The control of the sign cell's check: the plain reference's loop in the
program's place, computed in the precision just below the
configuration's (float32 for float64, TF32 off) on the A of the cell's
first window loop, and judged by the cell's own limits, as the
program's X is.  A sound check reads the control as not correct.

    python3 -m portbench.control_sign --workload h2o96.sign --seeds 11 12 13

From the root of a checkout, on the card (``--device cpu`` for a small
configuration).  Prints one JSON line a seed with each number beside its
limit; the benchmark's own runs never run it.  (`portbench.control`
holds the control of the cells that judge one product, a
``reference/blocksparse.py`` answer.)
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import harness
from portbench.reference import sign as ref

LOWER = {"float64": torch.float32}


def readings(cell: str, seed: int, device, pb_dir: str = harness.PB_DIR) -> dict:
    """The control's numbers, each with its limit: {name: (value, limit)}."""
    wl, cfg, kind = harness.load_cell(cell, pb_dir)
    inp = kind.Inputs(cfg, seed, torch.device(device))
    want = inp.reference(0)
    low = inp.reference(0, dtype=LOWER[cfg["dtype"]])
    got = ref.judge(low.x, ref.pattern_keys(low.pattern), low.steps, want, inp.trace)
    got["unconverged_loops"] = int(not low.history[-1] < inp.loop["tol"])
    return {k: (got[k], lim) for k, lim in wl["params"]["limits"].items()}


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
