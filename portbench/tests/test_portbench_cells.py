"""Each traffic kind end to end on the CPU at a tiny size, through the
harness to the result line, against the plain reference; and a cell
taken by adding files and entries alone."""

import json

import pytest

from portbench import harness
from portbench.tests import tiny


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_to_its_result_line(tmp_path, on_cpu, cell, trace):
    pb, bench = tiny.add_cells(tmp_path)
    out = harness.run_cell(cell, 2**31 + 977, 0.3, trace, "cpu", bench, 0.0, pb_dir=pb)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"] for m in harness.cell_metrics(bench, cell, trace)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert {"step_s", "setup_s"} <= set(line["metrics"])
    # no device number from a CPU run
    for name in ("products_roofline", "device_idle_pct", "launches_per_multiply",
                 "peak_mem_gb", "alloc_retries"):
        assert name not in line["metrics"]
    assert "busy_s" not in line["device"] and "breakdown" not in line
    for v in line["checks"].values():
        assert v["value"] <= v["limit"]


def test_same_seed_same_inputs(on_cpu):
    wl, cfg, kind = harness.load_cell("ns_f64.scf")
    cfg = dict(tiny.CONFIGS["tiny_ns"])
    a = kind.Inputs(cfg, 5, on_cpu).values("A", 3)
    b = kind.Inputs(cfg, 5, on_cpu).values("A", 3)
    c = kind.Inputs(cfg, 6, on_cpu).values("A", 3)
    assert all((x[2] == y[2]).all() for x, y in zip(a, b))
    assert not all((x[2] == y[2]).all() for x, y in zip(a, c))


def test_unknown_cell_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        harness.load_cell("no_such.cell", tiny.add_cells(tmp_path)[0])
