"""The benchmark's files: every entry of BENCHMARK.json has its file,
found by name, and BENCHMARK.json keeps to the contract's shapes."""

import json
import os
import re

import pytest

from portbench import harness
from portbench.tests.tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PB = harness.PB_DIR


def _one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_exist(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl, cfg, kind = harness.load_cell(cell, PB)
    assert wl["config"] == entry["config"] and wl["traffic"] == entry["traffic"]
    assert cfg["name"] == entry["config"] and cfg["chips"] == entry["chips"] == 1
    assert hasattr(kind, "setup") and hasattr(kind, "Inputs")
    assert _one_line(entry["why"])
    for m in harness.cell_metrics(BENCH, cell, False) + harness.cell_metrics(BENCH, cell, True):
        assert os.path.isfile(os.path.join(PB, "metrics", f"{m['name']}.py")), m["name"]


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metric_entries(group):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH[group]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
        assert set(m["workloads"] if "workloads" in m else cells) <= cells
        assert os.path.isfile(os.path.join(PB, "metrics", f"{m['name']}.py"))
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in e2e and _one_line(m["layer"])
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert not m["name"].endswith("_roofline") or m["unit"] == "%"


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(BENCH, w["name"], True)


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_config_files(cfg):
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg)
    with open(os.path.join(ROOT, entry["file"])) as f:
        data = json.load(f)
    assert entry["file"].startswith("portbench/configs/")
    assert data["name"] == cfg and data["reduced"] == entry["reduced"]
    assert all(NAME.match(k) and k in data for k in entry["reduced"])
    assert _one_line(entry["source"]) and entry["source"] == data["source"]
    assert any(w["config"] == cfg for w in BENCH["workloads"])
