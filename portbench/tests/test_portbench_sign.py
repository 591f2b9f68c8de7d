"""The sign cell (``h2o96.sign``, traffic kind ``sign_loop``): a tiny cell
of the same kind added the way a later change adds a cell, run on the
CPU through the harness to its result line; its three readers on stub
runs; its control and planted faults; and at the cell's own size on the
card (``card`` tests)."""

import json
import os
import subprocess
import sys
import time
import types

import pytest

from dbcsr_tpu_torch import models as dm
from portbench import control_sign, harness
from portbench.tests import tiny

TWIN = "h2o96.sign"
CELL = "tiny_sign.sign"
CONFIG = {"name": "tiny_sign", "dtype": "float64", "molecules": 5, "block": 4,
          "occupied_per_molecule": 1, "occupancy": 0.8, "filter_eps": 1e-10, "tol": 1e-10,
          "max_steps": 25, "pattern_seed": 9, "chips": 1, "reduced": []}
NEW = ("sign_ops_ms", "sign_steps", "filter_ms")
REAL = dm.sign_iteration


def add_sign_cell(tmp_path) -> tuple:
    """The tiny cells' copy of the benchmark (`tiny.add_cells`) with a
    tiny sign cell added: new files and new entries only."""
    pb, bench = tiny.add_cells(tmp_path)
    with open(os.path.join(pb, "configs", "tiny_sign.json"), "w") as f:
        json.dump(CONFIG, f)
    wl = harness.load_json(os.path.join(harness.PB_DIR, "workloads", f"{TWIN}.json"))
    wl.update(name=CELL, config="tiny_sign", why="test")
    with open(os.path.join(pb, "workloads", f"{CELL}.json"), "w") as f:
        json.dump(wl, f)
    bench["configs"].append({"name": "tiny_sign", "source": "test", "reduced": [],
                             "file": "portbench/configs/tiny_sign.json", "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny_sign", "traffic": "sign",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if TWIN in m.get("workloads", ()):
            m["workloads"].append(CELL)
    return pb, bench


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_sign_cell_runs_to_its_result_line(tmp_path, on_cpu, trace):
    pb, bench = add_sign_cell(tmp_path)
    out = harness.run_cell(CELL, 2**31 + 977, 0.3, trace, "cpu", bench, 0.0, pb_dir=pb)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"pattern_mismatch", "rel_err", "steps_mismatch",
                                   "trace_err", "unconverged_loops"}
    assert set(line["metrics"]) <= {m["name"] for m in harness.cell_metrics(bench, CELL, trace)}
    if trace:
        assert set(NEW) <= set(line["metrics"])
        assert line["metrics"]["sign_steps"]["value"] < CONFIG["max_steps"]
        for name in ("products_roofline", "device_idle_pct", "launches_per_multiply"):
            assert name not in line["metrics"]  # no device number from a CPU run
    else:
        assert set(line["metrics"]) == {"step_s", "setup_s"}


def _reader(name):
    return harness.load_module(os.path.join(harness.PB_DIR, "metrics", f"{name}.py"),
                               f"portbench_metric_{name}")


def _run(counters, steps=4):
    return types.SimpleNamespace(counters=counters, steps=steps, trace_summary=None,
                                 device=types.SimpleNamespace(type="cuda"))


FULL = {"multiplies": 80, "models": {"sign": {"loops": 4, "steps": 40, "rollbacks": 0}},
        "regions": {"models_sign_setup": {"calls": 4, "seconds": 0.004},
                    "models_sign_shift": {"calls": 40, "seconds": 0.016},
                    "models_sign_check": {"calls": 40, "seconds": 0.02},
                    "multiply_filter_norms": {"calls": 80, "seconds": 0.12},
                    "multiply_filter": {"calls": 80, "seconds": 0.04}}}


@pytest.mark.parametrize("name,want", [("sign_ops_ms", 10.0), ("sign_steps", 10.0),
                                       ("filter_ms", 2.0)])
def test_the_readers_read_the_program(name, want):
    assert _reader(name).read(_run(FULL)) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_them_reads_none(name):
    # what the parent reports: no models counter, no norm region, but
    # C's post-filter region, which it already timed
    parent = {"multiplies": 80, "regions": {"multiply_filter": {"calls": 80, "seconds": 0.04},
                                            "multiply": {"calls": 80, "seconds": 2.0}}}
    assert _reader(name).read(_run(parent)) is None
    assert _reader(name).read(_run({})) is None
    assert _reader(name).read(_run(dict(FULL, multiplies=0, models={}), steps=0)) is None


def test_the_new_entries():
    bench = tiny.BENCH
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert TWIN in entries[name]["workloads"] and entries[name]["moves"] == "step_s"
    assert entries["sign_ops_ms"]["layer"] == entries["sign_steps"]["layer"]
    for name in ("device_idle_pct", "products_roofline", "launches_per_multiply",
                 "host_index_ms", "host_assemble_ms", "index_plan_key_ms", "host_plan_ms",
                 "plan_hit_pct", "value_update_ms"):
        assert TWIN in entries[name]["workloads"], name
    step_s = next(m for m in bench["end_to_end"] if m["name"] == "step_s")
    assert TWIN in step_s["workloads"]
    cfg = next(c for c in bench["configs"] if c["name"] == "h2o96_sign_f64")
    data = harness.load_json(os.path.join(tiny.ROOT, cfg["file"]))
    assert data["reduced"] == [] and (data["molecules"], data["block"]) == (96, 23)
    assert len(cfg["source"]) <= 200


@pytest.mark.parametrize("seed", [1, 2**31 + 11, 2**40 + 3])
def test_control_fails_on_the_tiny_cell(tmp_path, on_cpu, seed):
    pb, _ = add_sign_cell(tmp_path)
    got = control_sign.readings(CELL, seed, "cpu", pb_dir=pb)
    assert got["rel_err"][0] > 1e-9 and got["unconverged_loops"][0] == 1


def _altered(a, **kw):
    x, history = REAL(a, **kw)
    x.bins[0].data.view(-1)[0] += 1e-6
    return x, history


def _short(a, **kw):
    return REAL(a, **dict(kw, steps=2))


@pytest.mark.parametrize("fault", [_altered, _short])
def test_fault_reads_incorrect(tmp_path, on_cpu, monkeypatch, fault):
    pb, bench = add_sign_cell(tmp_path)
    monkeypatch.setattr(dm, "sign_iteration", fault)
    out = harness.run_cell(CELL, 12345, 0.2, False, "cpu", bench, 0.0, pb_dir=pb)
    assert out["correct"] is False and out["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


def _loaded_after(code: str) -> list:
    env = dict(os.environ, PYTHONPATH=tiny.ROOT)
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, env=env, cwd=tiny.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import portbench.reference.sign")
    assert not [m for m in loaded if m.split(".")[0] in harness.FORBIDDEN + ("dbcsr_tpu_torch",)]


def test_a_sign_run_loads_no_jax_and_no_jax_package(tmp_path):
    code = (
        "from dbcsr_tpu_torch import device\n"
        "device.set_default_device('cpu')\n"
        "from portbench import harness\n"
        "from portbench.tests import test_portbench_sign as t\n"
        f"pb, bench = t.add_sign_cell({str(tmp_path)!r})\n"
        "out = harness.run_cell(t.CELL, 3, 0.2, True, 'cpu', bench, 0.0, pb_dir=pb)\n"
        "assert out['correct'], out\n"
        "import portbench.control_sign\n"
    )
    loaded = _loaded_after(code)
    assert "dbcsr_tpu_torch" in loaded
    assert not [m for m in loaded if m.split(".")[0] in harness.FORBIDDEN]


@pytest.mark.card
def test_control_fails_at_the_cells_own_size(card):
    got = control_sign.readings(TWIN, 2**31 + 21, card)
    print(json.dumps({k: v for k, (v, _) in got.items()}))
    assert got["rel_err"][0] > got["rel_err"][1]


@pytest.mark.card
def test_an_altered_value_reads_incorrect_at_the_cells_own_size(card, monkeypatch):
    """One value of X off by 1e-6, through a whole run of the committed
    cell at its own size on the card."""
    monkeypatch.setattr(dm, "sign_iteration", _altered)
    out = harness.run_cell(TWIN, 2**31 + 31, 1.0, False, card, tiny.BENCH, time.perf_counter())
    print(json.dumps(out["checks"]))
    assert out["correct"] is False and out["checks"]["rel_err"]["value"] > 1e-8
