"""Tiny cells of both traffic kinds, added to a copy of the benchmark's
folder the way a later change adds a cell: new files and new entries
only."""

from __future__ import annotations

import copy
import json
import os
import shutil

from portbench import harness

ROOT = os.path.dirname(harness.PB_DIR)
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))

CONFIGS = {
    "tiny_ns": {"name": "tiny_ns", "dtype": "float64", "blocks": [[5, 7], [3, 1]],
                "occupancy": {"A": 0.3, "B": 0.3, "C": 0.2}, "alpha": 1.0, "beta": 1.0,
                "pattern_seed": 3, "chips": 1, "reduced": []},
    "tiny_ri": {"name": "tiny_ri", "dtype": "float64", "molecules": 6, "block": 3,
                "occupancy": 0.3, "pattern_seed": 5, "chips": 1, "reduced": []},
    "tiny_f32": {"name": "tiny_f32", "dtype": "float32", "blocks": [[4, 6]],
                 "occupancy": {"A": 0.4, "B": 0.4, "C": 0.3}, "alpha": 1.0, "beta": 0.5,
                 "pattern_seed": 8, "chips": 1, "reduced": []},
    "tiny_c128": {"name": "tiny_c128", "dtype": "complex128", "molecules": 5, "block": 2,
                  "occupancy": 0.4, "pattern_seed": 6, "chips": 1, "reduced": []},
}
CELLS = {
    "tiny_ns.scf": {"name": "tiny_ns.scf", "config": "tiny_ns", "traffic": "scf",
                    "kind": "scf_multiply", "why": "test",
                    "params": {"warm_steps": 2, "check_steps": 2,
                               "limits": {"pattern_mismatch": 0, "rel_err": 1e-10}}},
    "tiny_ri.scf": {"name": "tiny_ri.scf", "config": "tiny_ri", "traffic": "scf",
                    "kind": "scf_contract", "why": "test",
                    "params": {"warm_steps": 1, "limits": {"pattern_mismatch": 0,
                                                           "rel_err": 1e-10,
                                                           "norm_rel_err": 1e-12}}},
    # float32 is judged against the float64 reference, complex128 against complex128
    "tiny_f32.scf": {"name": "tiny_f32.scf", "config": "tiny_f32", "traffic": "scf",
                     "kind": "scf_multiply", "why": "test",
                     "params": {"warm_steps": 1, "check_steps": 1,
                                "limits": {"pattern_mismatch": 0, "rel_err": 1e-5}}},
    "tiny_c128.scf": {"name": "tiny_c128.scf", "config": "tiny_c128", "traffic": "scf",
                      "kind": "scf_contract", "why": "test",
                      "params": {"warm_steps": 1, "limits": {"pattern_mismatch": 0,
                                                             "rel_err": 1e-10,
                                                             "norm_rel_err": 1e-12}}},
}
TWIN = {"scf_multiply": "ns_f64.scf", "scf_contract": "ri64_f64.scf"}


def add_cells(tmp_path) -> tuple:
    """A copy of the benchmark's folder and of BENCHMARK.json with the
    tiny cells added: (folder, benchmark dict)."""
    pb = os.path.join(str(tmp_path), "portbench")
    shutil.copytree(harness.PB_DIR, pb, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = copy.deepcopy(BENCH)
    for name, cfg in CONFIGS.items():
        with open(os.path.join(pb, "configs", f"{name}.json"), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": "test", "reduced": [],
                                 "file": f"portbench/configs/{name}.json", "why": "test"})
    for name, wl in CELLS.items():
        with open(os.path.join(pb, "workloads", f"{name}.json"), "w") as f:
            json.dump(wl, f)
        bench["workloads"].append({"name": name, "config": wl["config"],
                                   "traffic": wl["traffic"], "chips": 1, "why": "test"})
        twin = TWIN[wl["kind"]]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if twin in m.get("workloads", ()):
                m["workloads"].append(name)
    return pb, bench
