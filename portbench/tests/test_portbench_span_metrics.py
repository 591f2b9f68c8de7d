"""The readers of the program's spans and counters inside "index", the
plan cache, C's rebuild, the value update, the uploads and the
contraction's layout work, on stub runs: each reads its number where the
program reports it, and None, without raising, where a program that
lacks these spans and counters reports nothing."""

import os
import types

import pytest

from portbench import harness

NEW = ("index_expand_ms", "index_keys_ms", "index_plan_key_ms", "host_plan_ms",
       "plan_evictions", "rebuild_gb", "value_update_ms", "h2d_mb", "contract_layout_ms")


def _reader(name):
    return harness.load_module(os.path.join(harness.PB_DIR, "metrics", f"{name}.py"),
                               f"portbench_metric_{name}")


def _run(counters, steps=4):
    return types.SimpleNamespace(counters=counters, steps=steps, trace_summary=None,
                                 device=types.SimpleNamespace(type="cuda"))


def _region(calls, seconds):
    return {"calls": calls, "seconds": seconds}


FULL = {
    "multiplies": 8,
    "host_phase_s": {"index": 0.5},
    "plan_evictions": {"entries": 6, "bytes": 2, "pinned_bytes": 10**6},
    "rebuild_bytes": {"allocated": 3 * 10**9, "moved": 10**9},
    "h2d_bytes": 8 * 10**6,
    "regions": {"multiply_index_expand": _region(8, 0.08),
                "multiply_index_keys": _region(8, 0.24),
                "multiply_plan_key": _region(16, 0.16),
                "multiply_plan": _region(8, 0.04),
                "matrix_stage": _region(8, 0.004),
                "matrix_finalize": _region(8, 0.036),
                "tensor_restrict": _region(4, 0.001),
                "tensor_remap": _region(4, 0.003)},
}


@pytest.mark.parametrize("name,want", [
    ("index_expand_ms", 10.0), ("index_keys_ms", 30.0), ("index_plan_key_ms", 20.0),
    ("host_plan_ms", 5.0), ("plan_evictions", 1.0), ("rebuild_gb", 1.0),
    ("value_update_ms", 10.0), ("h2d_mb", 2.0),
    # no tensor_copy region: a contraction whose C already had its layout
    ("contract_layout_ms", 1.0)])
def test_reads_the_program_counters(name, want):
    assert _reader(name).read(_run(FULL)) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_them_reads_none(name):
    # what the program reported before these spans and counters
    parent = {k: FULL[k] for k in ("multiplies", "host_phase_s")}
    assert _reader(name).read(_run(parent)) is None
    assert _reader(name).read(_run({})) is None


@pytest.mark.parametrize("name", NEW)
def test_a_window_without_steps_or_multiplies_reads_none(name):
    assert _reader(name).read(_run(dict(FULL, multiplies=0), steps=0)) is None


def test_no_evictions_read_zero():
    counters = dict(FULL, plan_evictions={"entries": 0, "bytes": 0, "pinned_bytes": 0})
    assert _reader("plan_evictions").read(_run(counters)) == 0.0


def test_each_new_metric_has_its_entry_and_moves_step_s():
    bench = harness.load_json(os.path.join(os.path.dirname(harness.PB_DIR), "BENCHMARK.json"))
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["moves"] == "step_s" and m["workloads"], name
        assert os.path.exists(os.path.join(harness.PB_DIR, "metrics", f"{name}.py"))
    assert entries["contract_layout_ms"]["workloads"] == ["ri64_f64.scf"]
