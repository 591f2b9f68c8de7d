"""Time two checkouts of the repository in turns on one card.

Each run is a fresh process in the checkout's root that imports that
checkout's `chip_smoke.py`, points dispatch at an empty table directory
and turns incremental reuse off (as the smoke's `main` does), builds its
kernels (`phase_build`) and runs the phases named (``northstar``,
``models``, ``tensor_legs``, ``tensor``, ``superstack``, ``complex``,
``precision``), each of which
checks its own results and prints its JSON line.  A phase that takes
native K1's north-star stack time as an argument (``complex`` and
``precision`` where they do) gets it from a ``northstar_stacks`` run
first.  The checkouts run in
the order given, so ``parent change change parent`` puts each pair on
the same host in turns.  Every line goes to ``--out``; the summary
printed per run is the north star's seconds per multiply (repeats 2-3),
the model loops' walls under the planner (sign with the index engine),
the full-width contraction's wall and K1's stack milliseconds in it
(and its adaptive leg's kernel, probe and stack milliseconds), the
complex128 leg's kernel milliseconds,
the fused launch's milliseconds on `mixed_blocks` (between events and
the kernels' own, f64 and f32) and every ``*_stacks`` line's kernel
milliseconds.

    python3 -m dbcsr_tpu_torch.perf.tree_ab _archive/parent . . _archive/parent \\
        --phases northstar,models,tensor --out chiprun_out/tree_ab.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = """
import inspect, sys, tempfile
sys.path.insert(0, ".")
import chip_smoke as s
s.set_config(mm_driver="auto", validate_kernels=True, incremental="off")
s._use_table(tempfile.mkdtemp())
s.phase_build()
native = None
for phase in {phases!r}:
    fn = getattr(s, "phase_" + phase)
    if inspect.signature(fn).parameters:
        if native is None:
            ns = s.phase_northstar()
            native = s._stacks_phase("northstar_stacks", ns["a"], ns["b"], ns["c"])["ms"][0]
        fn(native)
    else:
        fn()
"""


def _summary(lines: list) -> dict:
    """The end-to-end numbers of one run's phase lines."""
    out = {}
    for ln in lines:
        phase = ln.get("phase")
        if phase == "northstar":
            out["northstar_s"] = ln["times_s"][1:]
        elif phase == "models":
            for name, key in (("purify", "auto"), ("sign", "native"), ("invsqrt", "auto")):
                runs = ln.get(name, {}).get("in_turns", {}).get(key, [])
                out[f"{name}_s"] = [r["wall_s"] for r in runs]
        elif phase == "tensor":
            out["contract_s"] = ln["auto"]["wall_s"]
            out["tensor_stack_ms"] = ln.get("stack_ms")
            ad = ln.get("adaptive", {})
            for key in ("kernel_ms", "probe_ms", "stack_ms"):
                out[f"tensor_adaptive_{key}"] = ad.get(key)
        elif phase == "tensor_legs":
            sd = ln.get("f32", {}).get("auto", {}).get("stack_device_s")
            out["tensor_legs_f32_stack_ms"] = None if sd is None else sd * 1e3
            out["tensor_legs_c128_kernel_ms"] = ln.get("c128", {}).get("kernel_ms")
        elif phase == "superstack":
            for dname, info in ln.get("dtypes", {}).items():
                fk = info.get("fused_kernel", {})
                out[f"fused_{dname}_ms"] = fk.get("ms")
                out[f"fused_{dname}_device_ms"] = fk.get("device_ms")
        elif phase and phase.endswith("_stacks"):
            out[phase + "_ms"] = ln["ms"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--phases", default="northstar,models,tensor")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "tree_ab.jsonl"))
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds per run")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    failed = 0
    with open(args.out, "w") as sink:
        for i, tree in enumerate(args.trees):
            proc = subprocess.run([sys.executable, "-c", _RUN.format(phases=phases)],
                                  cwd=tree, capture_output=True, text=True,
                                  timeout=args.timeout)
            lines = []
            for raw in proc.stdout.splitlines():
                if raw.startswith("{"):
                    lines.append(json.loads(raw))
                    sink.write(json.dumps({"run": i, "tree": tree, **lines[-1]}) + "\n")
            row = {"run": i, "tree": tree, "rc": proc.returncode, **_summary(lines)}
            if proc.returncode != 0:
                failed += 1
                row["stderr_tail"] = proc.stderr[-2000:]
            print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
