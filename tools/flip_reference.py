"""One silent flip in the guarded DFT loops with ABFT off, at the size of
`chip_smoke.py`'s models (2208^2: `make_test_density(96, 23, occ=0.2,
seed=0)`), in the JAX package or in the PyTorch port, on the CPU.

The integrity phase of `chip_smoke.py` injects
``execute_stack:flip,seed=13,times=1`` into purify (6 steps), sign
(p0 - 0.5 I, 25 steps, filter 1e-10) and invsqrt (p0 + 0.5 I, tol 1e-10)
with ABFT off, so the chain invariants are the only detector.  This
script runs the same loops, the same operands and the same spec in one
package and prints, per loop, one JSON line: whether the flip fired,
the rollbacks and chain recoveries counted, and the outcome against the
package's own clean loop ("bitwise", "differs" with the largest
difference, or the error raised).  Run it once per package:

    JAX_PLATFORMS=cpu python tools/flip_reference.py --package jax
    JAX_PLATFORMS=cpu python tools/flip_reference.py --package torch

``--blocks`` cuts the size (block rows of 23) for a quick check.  Both
packages run with ``mm_format="auto"``; the JAX package's incremental
multiply is off, since the port has none.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SPEC = "execute_stack:flip,seed=13,times=1"
PURIFY_STEPS, SIGN_STEPS, SIGN_EPS, INVSQRT_TOL = 6, 25, 1e-10, 1e-10


def _package(name: str):
    """The package's modules under one set of names."""
    if name == "jax":
        from dbcsr_tpu.core.config import set_config
        from dbcsr_tpu.models.invsqrt import invsqrt_iteration
        from dbcsr_tpu.models.purify import make_test_density, mcweeny_purify
        from dbcsr_tpu.models.sign import sign_iteration
        from dbcsr_tpu.obs import metrics
        from dbcsr_tpu.ops.operations import add_on_diag, copy
        from dbcsr_tpu.ops.test_methods import to_dense
        from dbcsr_tpu.resilience import breaker, faults
        from dbcsr_tpu.models.integrity import ChainIntegrityError

        set_config(mm_format="auto", incremental="off", abft="off")
        make = make_test_density
    else:
        from dbcsr_tpu_torch.core.config import set_config
        from dbcsr_tpu_torch.device import set_default_device
        from dbcsr_tpu_torch.models.invsqrt import invsqrt_iteration
        from dbcsr_tpu_torch.models.purify import make_test_density, mcweeny_purify
        from dbcsr_tpu_torch.models.sign import sign_iteration
        from dbcsr_tpu_torch.obs import metrics
        from dbcsr_tpu_torch.ops.operations import add_on_diag, copy
        from dbcsr_tpu_torch.ops.test_methods import to_dense
        from dbcsr_tpu_torch.resilience import breaker, faults
        from dbcsr_tpu_torch.models.integrity import ChainIntegrityError

        set_default_device("cpu")
        set_config(mm_format="auto", abft="off")
        make = make_test_density
    return dict(make=make, purify=mcweeny_purify, sign=sign_iteration,
                invsqrt=invsqrt_iteration, metrics=metrics, add_on_diag=add_on_diag,
                copy=copy, to_dense=to_dense, breaker=breaker, faults=faults,
                error=ChainIntegrityError)


def _ctr(metrics, name: str) -> float:
    return sum(v for _, v in metrics.counter_items(name))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--blocks", type=int, default=96)
    ap.add_argument("--loops", default="purify,sign,invsqrt")
    args = ap.parse_args()
    pk = _package(args.package)
    p0 = pk["make"](args.blocks, 23, occ=0.2, seed=0)
    a = pk["copy"](p0, "A")
    pk["add_on_diag"](a, -0.5)
    s = pk["copy"](p0, "S")
    pk["add_on_diag"](s, 0.5)
    loops = {"purify": lambda: pk["purify"](p0, steps=PURIFY_STEPS)[0],
             "sign": lambda: pk["sign"](a, steps=SIGN_STEPS, filter_eps=SIGN_EPS)[0],
             "invsqrt": lambda: pk["invsqrt"](s, tol=INVSQRT_TOL)[0]}
    for name in args.loops.split(","):
        t0 = time.perf_counter()
        clean = np.asarray(pk["to_dense"](loops[name]()))
        pk["metrics"].reset()
        outcome, diff = None, None
        try:
            with pk["faults"].inject_faults(SPEC) as sp:
                got = np.asarray(pk["to_dense"](loops[name]()))
        except pk["error"] as exc:
            outcome = type(exc).__name__
        finally:
            pk["breaker"].reset_board()
        if outcome is None:
            diff = float(np.abs(got - clean).max())
            outcome = "bitwise" if np.array_equal(got, clean) else "differs"
        print(json.dumps({
            "package": args.package, "loop": name, "n": args.blocks * 23, "spec": SPEC,
            "fired": sp[0].fired, "outcome": outcome, "max_abs_diff": diff,
            "rollbacks": _ctr(pk["metrics"], "dbcsr_tpu_chain_rollback_total"),
            "chain_recoveries": sum(v for lab, v in pk["metrics"].counter_items(
                "dbcsr_tpu_abft_recoveries_total") if str(lab.get("driver", "")).startswith(
                "chain:")),
            "seconds": time.perf_counter() - t0,
            "peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
