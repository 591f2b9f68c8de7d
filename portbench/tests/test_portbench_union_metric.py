"""The reader of C's key unions (`union_bitmap_pct`) on stub runs: the
share of unions that took the presence bitmap, and None, without
raising, where the program does not count its unions."""

import os
import types

import pytest

from portbench import harness

ENGINES = {"expand": {"native": 8, "numpy": 0}, "sort": {"native": 8, "numpy": 0},
           "coo_fill": {"native": 0, "numpy": 0}}


def _read(counters):
    reader = harness.load_module(os.path.join(harness.PB_DIR, "metrics", "union_bitmap_pct.py"),
                                 "portbench_metric_union_bitmap_pct")
    return reader.read(types.SimpleNamespace(counters=counters, steps=4, trace_summary=None))


@pytest.mark.parametrize("bitmap,sort,want", [(8, 0, 100.0), (0, 8, 0.0), (3, 1, 75.0)])
def test_reads_the_share_of_bitmap_unions(bitmap, sort, want):
    engines = dict(ENGINES, union={"bitmap": bitmap, "sort": sort})
    assert _read({"multiplies": 8, "index_engine": engines}) == pytest.approx(want)


@pytest.mark.parametrize("counters", [
    {"multiplies": 8, "index_engine": ENGINES},  # a program that does not count unions
    {"multiplies": 8},
    {},
    {"multiplies": 0, "index_engine": dict(ENGINES, union={"bitmap": 0, "sort": 0})}])
def test_reads_none_without_unions(counters):
    assert _read(counters) is None


def test_its_entry_is_in_the_multiply_host_layer_and_moves_step_s():
    bench = harness.load_json(os.path.join(os.path.dirname(harness.PB_DIR), "BENCHMARK.json"))
    entries = {m["name"]: m for m in bench["per_layer"]}
    m = entries["union_bitmap_pct"]
    assert m["layer"] == entries["index_keys_ms"]["layer"]
    assert m["moves"] == "step_s" and m["unit"] == "%" and m["source"] == "program_counter"
    assert m["workloads"] == ["ns_f64.scf", "ri64_f64.scf"]
