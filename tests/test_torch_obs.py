"""The stats, span-tracer, roofline and profile core of the port's obs
(dbcsr_tpu_torch.obs, core.stats, core.timings, core.lib, core.knobs and
the storage-format planner's observability), on the CPU.

* The pure functions give the JAX package's output for the same inputs:
  `chrome_events`, the cost model (`stack_flops`, `stack_bytes`,
  `superstack_bytes`, `dense_cost`, `intensity`, `format_costs`), the
  peak table and `roofline` on the kinds both tables hold (and their
  overrides), profiler `merge`/`diff`, `prometheus_text` of the same
  counters, gauges and histograms, and the planner's regret records on
  the same sequence of outcomes.
* The tracer on a multiply: ``multiply`` spans with their phase
  children and the product's m, n, k, ``stack`` instants with mnk,
  entries and driver, a JSONL shard per process and a Chrome trace with
  one complete event per span; activation by the environment.
* The event bus's JSONL sink, `core.stats` (per-(m,n,k) and per-driver
  accounting, marketing flops, the memory meters, ``keep_stats``), the
  metrics snapshot's roofline rows and first-use mirror, the flight
  recorder's memory and `dump`, the profile epochs, `core.lib`, the
  ``format_plan`` fault site, and the registry of environment knobs.

Every test resets both packages' metrics, events, health model and the
port's flight ring, profile epochs, planner and tracer.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dbcsr_tpu.core import stats as jax_stats
from dbcsr_tpu.mm import format_planner as jax_planner
from dbcsr_tpu.obs import costmodel as jax_costmodel
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import profiler as jax_profiler
from dbcsr_tpu.obs import timeseries as jax_timeseries
from dbcsr_tpu.obs import tracer as jax_tracer

import dbcsr_tpu_torch.obs as obs
from dbcsr_tpu_torch.acc import params
from dbcsr_tpu_torch.core import knobs, lib, stats, timings
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.mm import format_planner
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.obs import costmodel, events, flight, metrics, profiler, shard, tracer
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def reset_jax_plane():
    """The JAX package's runs in these tests feed its metrics, health
    model, events and telemetry store: all four are reset after every
    test, so a later file in the same worker (`tests/test_tune.py`'s
    admission checks) does not start from a DEGRADED or CRITICAL
    verdict."""
    yield
    for reset in (jax_metrics.reset, jax_health.reset, jax_events.clear, jax_timeseries.reset):
        reset()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [5, 3, 5, 3, 5]
_CFG = ("mm_format", "incremental", "keep_stats", "superstack")


@pytest.fixture(autouse=True)
def clean_both():
    cfg = {k: getattr(get_config(), k) for k in _CFG}

    def clear():
        tracer.disable()
        events.disable_sink()
        faults.clear()
        for m in (metrics, jax_metrics):
            m.reset()
        for e in (events, jax_events):
            e.clear()
        jax_health.reset()
        flight.clear()
        format_planner.reset()
        jax_planner.reset()
        mm.clear_plan_cache()
        timings.reset()

    clear()
    set_config(mm_format="stack", incremental="off")
    yield
    clear()
    set_config(**cfg)


def _product(beta=0.5, seed=3):
    rng = np.random.default_rng(seed)
    a, b, c = (port_tm.make_random_matrix(n, SIZES, SIZES, occupation=o, rng=rng, device="cpu")
               for n, o in (("A", 0.7), ("B", 0.7), ("C", 0.4)))
    mm.multiply("N", "N", 1.0, a, b, beta, c)
    return c


# ------------------------------------------------------ pure functions
_TRACE_RECORDS = [
    {"ev": "meta", "pid": 0},
    {"ev": "span", "name": "multiply", "ts_us": 1.5, "dur_us": 20.0, "depth": 0, "pid": 0,
     "tid": 7, "attrs": {"m": 5, "n": 5, "k": 5}},
    {"ev": "span", "name": "multiply_index", "ts_us": 2.0, "dur_us": 3.0, "depth": 1, "pid": 0},
    {"ev": "instant", "name": "stack", "ts_us": 9.0, "pid": 1, "tid": 3,
     "args": {"mnk": "5x5x5", "entries": 4, "driver": "pallas"}},
    {"ev": "instant", "name": "bare", "ts_us": 9.5, "pid": 1},
]


def test_chrome_events_match_jax():
    assert tracer.chrome_events(_TRACE_RECORDS) == jax_tracer.chrome_events(_TRACE_RECORDS)
    assert [e["ph"] for e in tracer.chrome_events(_TRACE_RECORDS)] == ["X", "X", "i", "i"]


@pytest.mark.parametrize("m,n,k,entries,nseg,itemsize",
                         [(5, 13, 23, 100, 40, 8), (23, 23, 23, 7, 7, 4), (1, 1, 1, 0, 3, 2)])
def test_cost_model_matches_jax(m, n, k, entries, nseg, itemsize):
    assert costmodel.stack_flops(m, n, k, entries) == jax_costmodel.stack_flops(m, n, k, entries)
    assert costmodel.stack_bytes(m, n, k, entries, nseg=nseg, itemsize=itemsize) == \
        jax_costmodel.stack_bytes(m, n, k, entries, nseg=nseg, itemsize=itemsize)
    spans = [(m, n, k, entries), (m, n, k + 3, entries + 5), (m, n, 2, 1)]
    assert costmodel.superstack_bytes(spans, nseg=nseg, itemsize=itemsize) == \
        jax_costmodel.superstack_bytes(spans, nseg=nseg, itemsize=itemsize)
    assert costmodel.dense_cost(m, n, k, itemsize=itemsize) == \
        jax_costmodel.dense_cost(m, n, k, itemsize=itemsize)
    assert costmodel.intensity(m * n, k) == jax_costmodel.intensity(m * n, k)


# the kinds both peak tables hold, and one neither does
KINDS = ["TPU v5 lite", "tpu v4", "TPU v6e", "tpu v5p", "cpu", "some other card"]


@pytest.mark.parametrize("kind", KINDS)
def test_roofline_matches_jax(kind):
    assert costmodel.peaks_for(kind) == jax_costmodel.peaks_for(kind)
    for dtype in ("float64", "float32", "bfloat16", "complex64", "complex128", "float16"):
        assert costmodel.peak_gflops(kind, dtype) == jax_costmodel.peak_gflops(kind, dtype)
        for flops, nbytes, secs in ((2.0e9, 3.0e8, 0.01), (5e6, 0, 1e-3), (1e9, 1e9, 0.0)):
            assert costmodel.roofline(flops, nbytes, secs, kind=kind, dtype=dtype) == \
                jax_costmodel.roofline(flops, nbytes, secs, kind=kind, dtype=dtype)


@pytest.mark.parametrize("panels", [None, (4, 3, 5)])
def test_format_costs_match_jax(panels):
    kw = dict(nbr=40, nbc=30, nbk=20, bm=23, bn=13, bk=5, entries=3000, panels=panels,
              dtype="float64", itemsize=8, kind="TPU v4")
    assert costmodel.format_costs(**kw) == jax_costmodel.format_costs(**kw)
    assert costmodel.format_costs(**dict(kw, nseg=11, dispatches=3)) == \
        jax_costmodel.format_costs(**dict(kw, nseg=11, dispatches=3))


def test_peak_overrides_match_jax(monkeypatch):
    row = json.dumps({"tpu v4": {"gbs": 777.0, "gflops": {"float64": 9.0}}, "newkind": {}})
    for pkg, prefix in ((costmodel, "DBCSR_TPU_TORCH_"), (jax_costmodel, "DBCSR_TPU_")):
        monkeypatch.setenv(prefix + "ROOFLINE", row)
        monkeypatch.setattr(pkg, "_env_table", None)
    assert costmodel.peaks_for("tpu v4") == jax_costmodel.peaks_for("tpu v4")
    assert costmodel.peaks_for("tpu v4")["gbs"] == 777.0
    for prefix in ("DBCSR_TPU_TORCH_", "DBCSR_TPU_"):
        monkeypatch.setenv(prefix + "PEAK_GFLOPS", "1234")
        monkeypatch.setenv(prefix + "PEAK_GBS", "55")
    for kind in ("tpu v4", "cpu"):
        assert costmodel.roofline(1e9, 1e8, 0.5, kind=kind) == \
            jax_costmodel.roofline(1e9, 1e8, 0.5, kind=kind)
    for pkg in (costmodel, jax_costmodel):
        monkeypatch.setattr(pkg, "_env_table", None)


def test_h100_row_is_the_data_sheet():
    peaks = costmodel.peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks["gbs"] == 3350.0
    assert peaks["gflops"] == {"float64": 67000.0, "float32": 67000.0, "bfloat16": 989000.0}
    assert costmodel.peak_gflops("NVIDIA H100 80GB HBM3", "complex128") == 67000.0 / 4
    assert costmodel.device_kind() == (torch.cuda.get_device_name(0)
                                       if torch.cuda.is_available() else "cpu")


def _snap(n, t0, cells, gen=3):
    return {"epoch": n, "t0": t0, "t1": t0 + 5, "n": n, "generation": gen, "cells": cells,
            "occ": {"pallas|32x32x32": [n, 0.5 * n]}}


def test_profiler_merge_and_diff_match_jax():
    a = _snap(4, 100.0, {"pallas|32x32x32|index": [4, 8.0, 3.0] + [1] * 18,
                         "pallas|32x32x32|launch": [4, 20.0, 6.0] + [0] * 18})
    b = _snap(2, 50.0, {"pallas|32x32x32|index": [2, 2.0, 1.5] + [2] * 18,
                        "dense|8x8x8|dense": [2, 1.0, 0.6] + [0] * 18}, gen=5)
    c = _snap(3, 200.0, {"pallas|32x32x32|index": [3, 30.0, 12.0] + [0] * 18,
                         "pallas|32x32x32|launch": [3, 12.0, 5.0] + [1] * 18})
    for snaps in ([a, b], [b, a, c], [], [a, {"n": 0}]):
        assert profiler.merge(snaps) == jax_profiler.merge(snaps)
    ab = profiler.merge([a, b])
    assert profiler.diff(ab, c) == jax_profiler.diff(jax_profiler.merge([a, b]), c)
    assert profiler.diff(c, ab, top=1) == jax_profiler.diff(c, ab, top=1)
    assert profiler.diff({}, c) == jax_profiler.diff({}, c)


def test_prometheus_text_matches_jax():
    for m in (metrics, jax_metrics):
        m.counter("dbcsr_tpu_x_total", "an x").inc(3, driver="pallas", kind="runtime")
        m.counter("dbcsr_tpu_x_total", "an x").inc(driver="fused", kind="nan")
        m.counter("dbcsr_tpu_y_total").inc(2)
        m.gauge("dbcsr_tpu_g", "a gauge").set(0.25, cell="5x5x5")
        h = m.histogram("dbcsr_tpu_fused_spans", "spans", buckets=(1, 2, 4, 8))
        for v in (2, 3, 9):
            h.observe(v)
    assert metrics.prometheus_text() == jax_metrics.prometheus_text()
    text = metrics.prometheus_text()
    sample = re.compile(r'^[a-z_]+(\{[a-z_]+="[^"]*"(,[a-z_]+="[^"]*")*\})? -?[0-9.e+-]+$')
    for line in text.splitlines():
        assert line.startswith("# HELP ") or line.startswith("# TYPE ") or sample.match(line), line


def _regret_plan(mod, fmt, occ, cell=(23, 23, 23, "float64")):
    predicted = {"stack": {"gflops": 10.0}, "dense": {"gflops": 40.0},
                 "composite": None if fmt != "composite" else {"gflops": 30.0}}
    return mod.Plan(fmt, "tuned", predicted=predicted, cell=cell, occ=occ, grid=(4, 4, 4))


def test_planner_regret_records_match_jax():
    outcomes = [("dense", 0.9, 0.5, 2.0e10), ("stack", 0.1, 2.0, 1.0e9),
                ("dense", 0.95, 1.0, 1.0e9), ("composite", 0.5, 0.1, 3.0e9),
                ("stack", 0.2, 0.0, 1.0e9)]
    for mod in (format_planner, jax_planner):
        for fmt, occ, secs, flops in outcomes:
            mod.note_outcome(_regret_plan(mod, fmt, occ), secs, flops)
        mod.note_outcome(mod.Plan("stack", "default"), 1.0, 1.0)  # no prediction: skipped

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "t_unix"} for r in recs]
    assert strip(format_planner.regret_records()) == strip(jax_planner.regret_records())
    assert len(format_planner.regret_records()) == 4
    assert format_planner.regret_gauges() == jax_planner.regret_gauges()
    assert strip(format_planner.mis_crossovers()) == strip(jax_planner.mis_crossovers())
    assert strip(format_planner.regret_records(limit=2)) == strip(jax_planner.regret_records(2))


def test_note_decision_counts_and_publishes_a_changed_choice():
    cell = (5, 5, 5, "float64")
    for fmt in ("stack", "stack", "dense"):
        format_planner.note_decision(format_planner.Plan(fmt, "tuned", cell=cell, occ=0.5))
    assert sorted(metrics.counter_items("dbcsr_tpu_format_decision_total"),
                  key=lambda x: x[0]["format"]) == [
        ({"format": "dense", "reason": "tuned"}, 1.0),
        ({"format": "stack", "reason": "tuned"}, 2.0)]
    (ev,) = events.records(kind="format_decision")
    assert (ev["format"], ev["prev"]) == ("dense", "stack:tuned")


def test_format_plan_fault_degrades_one_product_to_stack():
    set_config(mm_format="dense")
    with faults.inject_faults("format_plan:raise,times=1"):
        c1 = _product()
        c2 = _product()
    assert (c1._mm_algorithm, c2._mm_algorithm) == ("stack", "dense")
    recs = [r for r in flight.records() if r.get("format")]
    assert [(r["format"], r["format_reason"]) for r in recs] == [
        ("stack", "fault"), ("dense", "forced")]


# ------------------------------------------------------------ the tracer
def test_tracer_on_a_multiply(tmp_path):
    base = str(tmp_path / "trace.jsonl")
    t = obs.enable_trace(base)
    assert obs.trace_enabled() and obs.get_tracer() is t
    c = _product()
    obs.disable_trace()
    assert t.path == shard.shard_path(base, 0) and not obs.trace_enabled()
    with open(t.path) as f:
        recs = [json.loads(line) for line in f]
    spans = [r for r in recs if r["ev"] == "span"]
    (top,) = [r for r in spans if r["name"] == "multiply"]
    assert top["depth"] == 0 and (top["attrs"]["m"], top["attrs"]["n"]) == (21, 21)
    assert top["attrs"]["algorithm"] == "stack" and top["attrs"]["format"] == "stack"
    children = {r["name"] for r in spans if r["depth"] == 1}
    assert {"multiply_index", "multiply_c_assemble", "multiply_stacks"} <= children
    (stacks_span,) = [r for r in spans if r["name"] == "multiply_stacks"]
    stacks = [r for r in recs if r["ev"] == "instant" and r["name"] == "stack"]
    assert stacks and {"mnk", "entries", "driver"} <= set(stacks[0]["args"])
    assert stacks_span["attrs"]["stack_entries"] == sum(s["args"]["entries"] for s in stacks)
    assert sum(s["args"]["entries"] for s in stacks) == sum(sp[3] for sp in c._mm_spans)
    with open(t.chrome_path) as f:
        doc = json.load(f)
    assert sum(e["ph"] == "X" for e in doc["traceEvents"]) == len(spans)
    assert {e["name"] for e in doc["traceEvents"] if e["ph"] == "i"} >= {"stack", "multiply_end"}


def test_timed_regions_feed_the_tracer(tmp_path):
    t = tracer.enable(str(tmp_path / "t.jsonl"))
    with timings.timed("outer"):
        tracer.annotate(x=1)
        with timings.timed("inner"):
            tracer.add("bytes", 5)
            tracer.add("bytes", 2)
        tracer.instant("mark", {"a": 1})
    tracer.disable()
    spans = [e for e in t.events if e["ev"] == "span"]
    assert [(s["name"], s["depth"]) for s in spans] == [("inner", 1), ("outer", 0)]
    assert spans[0]["attrs"] == {"bytes": 7} and spans[1]["attrs"] == {"x": 1}
    assert timings._stats["outer"].calls == 1


def test_environment_activates_tracer_and_sink(tmp_path):
    script = ("import numpy as np\n"
              "from dbcsr_tpu_torch.ops import test_methods as tm\n"
              "from dbcsr_tpu_torch.mm.multiply import multiply\n"
              "rng = np.random.default_rng(0)\n"
              "a, b, c = (tm.make_random_matrix(n, [3, 4], [3, 4], occupation=1.0, rng=rng,"
              " device='cpu') for n in 'ABC')\n"
              "multiply('N', 'N', 1.0, a, b, 0.0, c)\n")
    env = dict(os.environ, DBCSR_TPU_TORCH_TRACE=str(tmp_path / "t.jsonl"),
               DBCSR_TPU_TORCH_EVENTS=str(tmp_path / "e.jsonl"))
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    with open(tmp_path / "t.p0.jsonl.chrome.json") as f:
        assert any(e["name"] == "multiply" for e in json.load(f)["traceEvents"])
    with open(tmp_path / "e.p0.jsonl") as f:
        kinds = [json.loads(line)["event"] for line in f]
    assert kinds[0] == "multiply_begin" and kinds[-1] == "multiply_end"


# ------------------------------------------------------- bus, shard, flight
def test_events_sink_and_rebind(tmp_path):
    base = str(tmp_path / "ev.jsonl")
    path = events.enable_sink(base)
    assert path == events.sink_path() and events.sink_active()
    events.publish("one", {"v": 1})
    events.rebind(3)
    assert events.sink_path() == shard.shard_path(base, 3)
    events.publish("two", {"v": 2})
    events.disable_sink()
    with open(shard.shard_path(base, 3)) as f:
        assert [json.loads(line)["event"] for line in f] == ["one", "two"]


def test_shard_settle_appends_onto_an_existing_shard(tmp_path):
    base = str(tmp_path / "s.jsonl")
    assert shard.shard_path(base, 2).endswith("s.p2.jsonl")
    assert shard.process_index() is None  # no process group
    assert shard.provisional_tag().startswith("tmp")
    final = shard.shard_path(base, 0)
    with open(final, "w") as f:
        f.write("old\n")
    tmp = shard.shard_path(base, shard.provisional_tag())
    fh = open(tmp, "w")
    fh.write("new\n")
    path, fh = shard.settle(base, tmp, fh, 0)
    fh.close()
    assert path == final and not os.path.exists(tmp)
    with open(final) as f:
        assert f.read() == "old\nnew\n"


def test_flight_records_memory_and_dumps(tmp_path):
    _product()
    (rec,) = flight.records()
    assert rec["memory"]["host_peak"] > 0 and tuple(rec["mnk"]) == (21, 21, 21)
    lines = []
    flight.dump(path=str(tmp_path / "f.json"), out=lines.append)
    assert lines[0].startswith(" FLIGHT RECORDER") and "alg=stack" in lines[1]
    with open(tmp_path / "f.json") as f:
        assert json.load(f)[0]["seq"] == rec["seq"]


def test_profile_epochs_seal_by_generation(monkeypatch):
    monkeypatch.setattr(profiler, "_epoch_n", 2)
    for _ in range(3):
        _product()
    (ep,) = profiler.epochs()
    assert ep["n"] == 2 and ep["generation"] == params.generation()
    assert any(k.endswith("|launch") for k in ep["cells"])
    assert profiler.current()["n"] == 1 and profiler.totals()["n"] == 3
    assert profiler.seal()["n"] == 1 and profiler.seal() is None


# -------------------------------------------------------- stats and metrics
def test_stats_account_a_multiply():
    set_config(superstack="per_span")
    c = _product()
    spans = c._mm_spans
    flops = sum(2 * m * n * k * e for m, n, k, e, *_ in spans)
    assert stats.total_flops() == flops
    assert stats._totals == {"multiplies": 1, "flops": 0, "marketing_flops": 2 * 21 ** 3}
    snap = metrics.snapshot()
    assert snap["flops_by_driver"] == {"pallas": flops}
    assert sum(v["entries"] for v in snap["by_mnk"].values()) == sum(sp[3] for sp in spans)
    row = snap["roofline"]["pallas"]
    assert row["stacks"] == len(spans) and row["device_kind"] == "cpu"
    assert row["bytes_moved"] == stats.driver_rollup()["pallas"]["bytes"] > 0
    assert snap["memory"]["host_peak"] > 0
    assert snap["jit"]["smm_stack"]["compiles"] == len({sp[:3] for sp in spans})
    lines = []
    stats.print_statistics(out=lines.append)
    assert any("DBCSR-TPU STATISTICS" in x for x in lines)
    assert any("marketing flops" in x for x in lines)
    metrics.reset()
    set_config(keep_stats=False)
    _product()
    assert stats.total_flops() == 0 and stats.driver_rollup() == {}


def test_stats_comm_and_overlap_match_jax():
    for st in (stats, jax_stats):
        st.record_comm("ppermute", 3, 4096)
        st.record_cannon_overlap("dense", "2x2", mode="db", modeled=0.5, measured=0.25)
        st.record_cannon_overlap("dense", "2x2", drop_measured=True)
    assert stats.cannon_overlap_rollup() == jax_stats.cannon_overlap_rollup()
    assert dict(stats._comm) == {"ppermute": stats._CommStat(3, 4096)}
    jax_stats.reset()


def test_lib_prints_statistics_and_the_obs_snapshot(tmp_path):
    lib.init_lib()
    _product()
    tracer.enable(str(tmp_path / "t.jsonl"))
    lines = []
    lib.finalize_lib(print_stats=True, out=lines.append)
    assert any("DBCSR-TPU STATISTICS" in x for x in lines)
    snap = json.loads(lines[-1])
    assert snap["obs_schema"] == obs.OBS_SCHEMA_VERSION and "roofline" in snap["snapshot"]
    assert stats.total_flops() == 0 and not timings._stats


# ----------------------------------------------------------------- knobs
def test_every_knob_literal_is_registered():
    literal = re.compile(r"DBCSR_TPU_TORCH_[A-Z0-9_]*[A-Z0-9]")
    found = set()
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "dbcsr_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    read = set()
    for p in paths:
        with open(p) as f:
            text = f.read()
        found |= set(literal.findall(text))
        if not p.endswith("knobs.py"):
            read |= set(literal.findall(text))
    assert found <= set(knobs.KNOBS), found - set(knobs.KNOBS)
    assert set(knobs.KNOBS) <= read, set(knobs.KNOBS) - read
    for name, meta in knobs.KNOBS.items():
        assert os.path.exists(os.path.join(ROOT, "dbcsr_tpu_torch", meta["owner"])), name
        assert meta["doc"]
