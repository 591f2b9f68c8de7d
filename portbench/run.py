#!/usr/bin/env python3
"""Run one cell of the benchmark of ``dbcsr_tpu_torch`` on one NVIDIA GPU.

    python3 portbench/run.py --workload ns_f64.scf --seed 7 --seconds 30 --trace 0

From the root of a checkout.  Prints the cell's metrics as the last line
of standard output (one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` a ``breakdown``,
and last ``checks``: each number held against the plain reference,
beside its limit), and the same checks as the last lines of standard
error.  ``--trace 0`` reports the cell's end-to-end metrics of
``BENCHMARK.json``, ``--trace 1`` its per-layer metrics, from a
`torch.profiler` trace of the window.

Every run sets ``OMP_WAIT_POLICY=PASSIVE`` before the program loads: the
program's index engine and PyTorch each keep an OpenMP thread pool, and
threads of one that spin while they wait take the host's cores from the
other's work, which made the steps' times swing from run to run.

Exits 2 without a result where no CUDA device (or fewer than the cell
asks for) is visible.  Build and kernel caches stay inside the
checkout: the program's libraries in ``dbcsr_tpu_torch/_build/``, and
``TORCH_EXTENSIONS_DIR`` and ``TRITON_CACHE_DIR`` under
``.portbench_cache/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

PB_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB_DIR)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(cells)}",
              file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                           bench, T_START, chips=chips)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
