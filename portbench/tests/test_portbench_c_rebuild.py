"""The readers of C's rebuilds on stub runs: how often C's bins were kept
(`rebuild_kept_pct`, the share of stack multiplies that kept them) and
the host time of a TAS split's pre-build of C (`tas_prebuild_ms`), each
None, without raising, where the program does not count or time it."""

import os
import types

import pytest

from portbench import harness


def _read(counters, name="rebuild_kept_pct", steps=4):
    reader = harness.load_module(os.path.join(harness.PB_DIR, "metrics", f"{name}.py"),
                                 f"portbench_metric_{name}")
    return reader.read(types.SimpleNamespace(counters=counters, steps=steps, trace_summary=None))


@pytest.mark.parametrize("kept,rebuilt,prebuilt,want", [
    (64, 0, 1, 100.0), (0, 8, 0, 0.0), (3, 1, 0, 75.0)])
def test_reads_the_share_of_multiplies_that_kept_c(kept, rebuilt, prebuilt, want):
    counts = {"rebuilt": rebuilt, "kept": kept, "prebuilt": prebuilt}
    assert _read({"multiplies": kept + rebuilt, "c_rebuild": counts}) == pytest.approx(want)


@pytest.mark.parametrize("counters", [
    {"multiplies": 8, "rebuild_bytes": {"allocated": 1, "moved": 0}},  # a program without it
    {"multiplies": 8, "c_rebuild": None},
    {},
    {"multiplies": 0, "c_rebuild": {"rebuilt": 0, "kept": 0, "prebuilt": 0}}])
def test_reads_none_without_the_counter(counters):
    assert _read(counters) is None


def test_reads_the_prebuild_seconds_a_step():
    regions = {"tas_c_prebuild": {"calls": 4, "seconds": 0.8}, "multiply_index": {
        "calls": 256, "seconds": 9.0}}
    assert _read({"multiplies": 256, "regions": regions}, "tas_prebuild_ms") \
        == pytest.approx(200.0)


@pytest.mark.parametrize("counters,steps", [
    ({"multiplies": 256, "regions": {"multiply_index": {"calls": 256, "seconds": 9.0}}}, 4),
    ({"multiplies": 8}, 4),  # a program without regions
    ({}, 4),
    ({"regions": {"tas_c_prebuild": {"calls": 1, "seconds": 0.2}}}, 0)])
def test_reads_no_prebuild_time_without_the_region(counters, steps):
    assert _read(counters, "tas_prebuild_ms", steps) is None


@pytest.mark.parametrize("name,layer_of,source,unit,workloads", [
    ("rebuild_kept_pct", "rebuild_gb", "program_counter", "%",
     ["ns_f64.scf", "ri64_f64.scf", "h2o96.sign"]),
    ("tas_prebuild_ms", "tas_groups", "program_span", "ms", ["ri64_f64.scf"])])
def test_its_entry_is_in_its_layer_and_moves_step_s(name, layer_of, source, unit, workloads):
    bench = harness.load_json(os.path.join(os.path.dirname(harness.PB_DIR), "BENCHMARK.json"))
    entries = {m["name"]: m for m in bench["per_layer"]}
    m = entries[name]
    assert m["layer"] == entries[layer_of]["layer"]
    assert m["moves"] == "step_s" and m["unit"] == unit and m["source"] == source
    assert m["workloads"] == workloads
