"""The port's spans and counters where a step's host time goes, on the CPU.

`mm.multiply.read_totals` reads, since `reset_totals`: every
`core.timings` region (the multiply's "index" in three parts, plan
building apart from launching, the matrix layer's value update, the
contraction's layout work), the plan cache's evictions by cause, the
bytes C's rebuild allocates and moves, the multiplies that rebuilt or
kept C's bins and the TAS split's pre-builds, and the host-to-device
bytes of `core.mempool`, which `core.matrix.to_index` and `to_device`
now feed.
`reset_totals` takes baselines of the timer registry and of the
transfer counter and clears neither.  The tracer stamps its spans on
`torch.profiler`'s clock.  No counterpart in the JAX package: these are
the port's own readings.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from dbcsr_tpu_torch.core import matrix as core_matrix
from dbcsr_tpu_torch.core import mempool, timings
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.mm import incremental as _incremental
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.models import make_test_density, sign_iteration
from dbcsr_tpu_torch.obs import tracer
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.ops.operations import scale
from dbcsr_tpu_torch.tas import tas_multiply
from dbcsr_tpu_torch.tensor import contract, create_tensor

SIZES = [3, 5, 2, 4]
INDEX_PARTS = ("multiply_index_expand", "multiply_index_keys", "multiply_plan_key")
STACK_PARTS = ("multiply_plan", "multiply_launch")
LAYOUT_PARTS = ("tensor_restrict", "tensor_remap", "tensor_copy")
SIGN_PARTS = ("models_sign_setup", "models_sign_shift", "models_sign_check")
NO_FILTER = {"candidates": 0, "dropped": 0, "blocks_kept": 0, "blocks_dropped": 0}


@pytest.fixture(autouse=True)
def fresh():
    mm.clear_plan_cache()
    mm.reset_totals()
    yield
    mm.clear_plan_cache()
    tracer.disable()


def _operands(seed=1, occ=(0.6, 0.6, 0.3)):
    rng = np.random.default_rng(seed)
    return [port_tm.make_random_matrix(name, SIZES, SIZES, occupation=o, rng=rng, device="cpu")
            for name, o in zip("ABC", occ)]


def _tensors(seed=3):
    """T(i,j,k) mapped (i | j,k), M(k,l), and an empty C(i,j,l) mapped
    (i | j,l): the contraction remaps T and copies its result into C's
    mapping."""
    si, sj, sk, sl = [2, 3], [3, 2], [4, 2], [2, 2]
    rng = np.random.default_rng(seed)
    t = create_tensor("T", [si, sj, sk], (0,), (1, 2), device="cpu")
    m = create_tensor("M", [sk, sl], (0,), (1,), device="cpu")
    for x, occ in ((t, 0.8), (m, 0.9)):
        for idx in np.ndindex(*[len(b) for b in x.blk_sizes]):
            if rng.random() < occ:
                x.put_block(idx, rng.standard_normal(x.block_shape(idx)))
        x.finalize()
    c = create_tensor("C", [si, sj, sl], (0,), (1, 2), device="cpu")
    c.finalize()
    return t, m, c


_RI = dict(contract_a=(2,), notcontract_a=(0, 1), contract_b=(0,), notcontract_b=(1,),
           map_1=(0, 1), map_2=(2,))


# ------------------------------------------------------------- regions
def test_stack_multiply_regions_nest_in_their_parents():
    a, b, c = _operands()
    timings.reset()  # the regions' seconds from zero, so they compare exactly
    mm.multiply("N", "N", 1.0, a, b, 0.5, c)
    regions = mm.read_totals()["regions"]
    for name in ("multiply", "multiply_index", "multiply_stacks") + INDEX_PARTS + STACK_PARTS:
        assert regions[name]["calls"] >= 1, name
    # C's fingerprint and the rest of the key: one region, entered twice
    assert regions["multiply_plan_key"]["calls"] == 2 * regions["multiply_index"]["calls"]
    for parent, parts in (("multiply_index", INDEX_PARTS), ("multiply_stacks", STACK_PARTS)):
        assert sum(regions[p]["seconds"] for p in parts) <= regions[parent]["seconds"]
    # the host phases are read off the same clock
    phase = c._mm_phase_s
    assert regions["multiply_index"]["seconds"] == phase["index"]


def test_contraction_regions_nest_in_their_parents():
    t, m, c = _tensors()
    contract(1.0, t, m, 0.0, c, **_RI)
    regions = mm.read_totals()["regions"]
    for name in ("tensor_contract", "tas_multiply", "matrix_stage", "matrix_finalize")\
            + LAYOUT_PARTS + INDEX_PARTS + STACK_PARTS:
        assert regions[name]["calls"] >= 1, name
    assert sum(regions[p]["seconds"] for p in LAYOUT_PARTS) + regions["tas_multiply"]["seconds"] \
        <= regions["tensor_contract"]["seconds"]


def test_value_update_is_timed_and_an_empty_finalize_is_not():
    a, _, _ = _operands()
    mm.reset_totals()
    a.finalize()  # nothing staged
    assert "matrix_finalize" not in mm.read_totals()["regions"]
    bins = a.bins[0]
    keys = a.keys[a.ent_bin == 0]
    rows, cols = keys // a.nblkcols, keys % a.nblkcols
    a.stage_device_blocks(rows, cols, torch.ones_like(bins.data[: len(rows)]))
    a.finalize()
    regions = mm.read_totals()["regions"]
    assert regions["matrix_stage"]["calls"] == 1 and regions["matrix_finalize"]["calls"] == 1


def test_regions_count_from_the_reset():
    a, b, c = _operands()
    mm.multiply("N", "N", 1.0, a, b, 0.0, c.copy())
    mm.reset_totals()
    assert mm.read_totals()["regions"] == {}
    mm.multiply("N", "N", 1.0, a, b, 0.0, c.copy())
    assert mm.read_totals()["regions"]["multiply"]["calls"] == 1
    # a registry reset after the baseline: counted from zero again
    timings.reset()
    mm.multiply("N", "N", 1.0, a, b, 0.0, c.copy())
    assert mm.read_totals()["regions"]["multiply"]["calls"] == 1


def test_reset_totals_clears_neither_the_registry_nor_the_transfer_counter():
    a, b, c = _operands()
    mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    before = mempool.transfer_totals()
    lines = []
    timings.report(out=lines.append)
    mm.reset_totals()
    assert mempool.transfer_totals() == before
    after = []
    timings.report(out=after.append)
    assert after == lines and any("multiply_index_expand" in ln for ln in lines)


# ------------------------------------------------- the sign loop and filter
def test_a_sign_loop_fills_its_regions_and_counts_its_loop():
    a = make_test_density(4, 3, occ=0.6, seed=2, device="cpu")
    _, history = sign_iteration(a, steps=30, filter_eps=1e-10, tol=1e-10)
    totals = mm.read_totals()
    regions = totals["regions"]
    steps = len(history)
    assert regions["models_sign_setup"]["calls"] == 1
    assert regions["models_sign_shift"]["calls"] == regions["models_sign_check"]["calls"] == steps
    # two filtered multiplies a step, each reading its operands' norms
    # inside the expansion and post-filtering C
    assert totals["multiplies"] == 2 * steps
    for name in ("multiply_filter_norms", "multiply_filter", "multiply_index_expand"):
        assert regions[name]["calls"] == 2 * steps, name
    assert regions["multiply_filter_norms"]["seconds"] <= \
        regions["multiply_index_expand"]["seconds"]
    assert totals["models"] == {"sign": {"loops": 1, "steps": steps, "rollbacks": 0}}
    f = totals["filter"]
    assert f["candidates"] > 0 and f["blocks_kept"] > 0
    assert 0 <= f["dropped"] <= f["candidates"]
    sign_iteration(a, steps=30, filter_eps=1e-10, tol=1e-10)
    assert mm.read_totals()["models"]["sign"]["loops"] == 2


def test_reset_totals_clears_the_models_and_filter_counters():
    sign_iteration(make_test_density(4, 3, seed=1, device="cpu"), steps=3, filter_eps=1e-10)
    assert mm.read_totals()["models"] and mm.read_totals()["filter"] != NO_FILTER
    mm.reset_totals()
    totals = mm.read_totals()
    assert totals["models"] == {} and totals["filter"] == NO_FILTER
    assert not set(SIGN_PARTS + ("multiply_filter_norms",)) & set(totals["regions"])


def test_the_filter_counts_candidates_from_the_patterns():
    a, b, c = _operands(seed=4)
    per_row_b = np.diff(b.row_ptr)
    want = int(per_row_b[a.keys % a.nblkcols].sum())
    mm.multiply("N", "N", 1.0, a, b, 0.0, c.copy(), filter_eps=1e-12)
    assert mm.read_totals()["filter"]["candidates"] == want
    assert mm.read_totals()["filter"]["dropped"] == 0
    mm.reset_totals()
    # an eps above every product drops each candidate, and C is empty
    out = c.copy()
    mm.multiply("N", "N", 1.0, a, b, 0.0, out, filter_eps=1e6)
    assert mm.read_totals()["filter"]["candidates"] == mm.read_totals()["filter"]["dropped"] == want
    assert mm.read_totals()["filter"]["blocks_kept"] == len(out.keys)


def test_an_unfiltered_multiply_counts_no_filter():
    a, b, c = _operands()
    mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    totals = mm.read_totals()
    assert totals["filter"] == NO_FILTER and totals["models"] == {}
    assert "multiply_filter_norms" not in totals["regions"]


# ------------------------------------------------------------ plan cache
def _entry(nbytes):
    e = mm._CachedSpans([])
    e.nbytes = nbytes
    return e


def test_the_entry_cap_evicts_and_names_its_cause():
    """Plans under the per-entry floor: the budget holds 4,096 of them,
    and one more evicts the least recent, counted under "entries" with
    the bytes it pinned."""
    cap = mm._PLAN_CACHE_MAX_BYTES // mm._PLAN_ENTRY_FLOOR
    assert cap == 4096
    for i in range(cap + 1):
        mm._plan_cache_insert(("plan", i), _entry(10))
    totals = mm.read_totals()
    assert totals["plan_evictions"] == {"entries": 1, "bytes": 0, "pinned_bytes": 10}
    assert ("plan", 0) not in mm._plan_cache and len(mm._plan_cache) == cap
    assert totals["plan_cache_resident"] == {"entries": cap, "bytes": 10 * cap}


def test_the_byte_cap_evicts_and_names_its_cause(monkeypatch):
    monkeypatch.setattr(mm, "_PLAN_CACHE_MAX_BYTES", 100)
    mm._plan_cache_insert(("plan", 0), _entry(60))
    mm._plan_cache_insert(("plan", 1), _entry(50))
    ev = mm.read_totals()["plan_evictions"]
    assert ev == {"entries": 0, "bytes": 1, "pinned_bytes": 60}
    # the same key again replaces its entry: no eviction
    mm._plan_cache_insert(("plan", 1), _entry(50))
    assert mm.read_totals()["plan_evictions"]["bytes"] == 1


def test_distinct_products_evict_over_the_entry_cap(monkeypatch):
    """17 distinct products, past the JAX package's 16, all stay resident
    and hit on repeat; with a budget the floor fills at 17 entries, an
    18th evicts the least recent under "entries"."""
    a, b, c = _operands()
    n = len(SIZES)

    def product(i):
        out = c.copy()
        mm.multiply("N", "N", 1.0, a, b, 0.0, out, last_row=i % n,
                    last_col=i // n % n, first_k=i // n // n)
        return out._mm_plan_cache

    assert [product(i) for i in range(17)] == ["miss"] * 17
    assert [product(i) for i in range(17)] == ["hit"] * 17
    assert mm.read_totals()["plan_evictions"]["entries"] == 0
    monkeypatch.setattr(mm, "_PLAN_CACHE_MAX_BYTES", 17 * mm._PLAN_ENTRY_FLOOR)
    assert product(17) == "miss"
    assert mm.read_totals()["plan_evictions"]["entries"] == 1
    assert product(0) == "miss" and product(16) == "hit"


# ------------------------------------------------------------ C's rebuild
def _block_bytes(m, keys):
    r, c = keys // m.nblkcols, keys % m.nblkcols
    return int(np.sum(m.row_blk_sizes[r] * m.col_blk_sizes[c])) * 8


@pytest.mark.parametrize("beta", [0.0, 1.0, 0.5])
def test_rebuild_bytes_are_the_blocks_allocated_and_moved(beta):
    a, b, c = _operands(seed=2)
    old_keys = c.keys.copy()
    mm.multiply("N", "N", 1.0, a, b, beta, c)
    rb = mm.read_totals()["rebuild_bytes"]
    assert rb["allocated"] == _block_bytes(c, c.keys) > 0
    assert rb["moved"] == (0 if beta == 0 else _block_bytes(c, old_keys))


def test_rebuild_bytes_in_a_window_count_every_block_moved():
    a, b, c = _operands(seed=2, occ=(0.6, 0.6, 0.8))
    old_keys = c.keys.copy()
    mm.multiply("N", "N", 1.0, a, b, 0.5, c, first_row=1, last_row=2)
    rb = mm.read_totals()["rebuild_bytes"]
    assert rb["allocated"] == _block_bytes(c, c.keys)
    assert rb["moved"] == _block_bytes(c, old_keys)


def _split_operands(seed=5, c_occ=0.3):
    """A tall A, a square B and a tall C for a split into row groups."""
    rng = np.random.default_rng(seed)
    tall, short = [3, 5, 2, 4] * 3, [2, 4, 3]
    return [port_tm.make_random_matrix(name, rows, cols, occupation=o, rng=rng, device="cpu")
            for name, rows, cols, o in (("A", tall, short, 0.5), ("B", short, short, 0.8),
                                        ("C", tall, short, c_occ))]


@pytest.mark.parametrize("beta", [0.0, 1.0, 0.5])
def test_a_split_prebuilds_c_once_and_keeps_its_bins(beta):
    a, b, c = _split_operands()
    old_keys = c.keys.copy()
    tas_multiply("N", "N", 1.0, a, b, beta, c, nsplit=4)
    totals = mm.read_totals()
    assert totals["c_rebuild"] == {"rebuilt": 0, "kept": 4, "prebuilt": 1}
    assert totals["multiplies"] == 4 and totals["regions"]["tas_c_prebuild"]["calls"] == 1
    # C's final bins allocated once, the old blocks moved once
    rb = totals["rebuild_bytes"]
    assert rb["allocated"] == _block_bytes(c, c.keys) > _block_bytes(c, old_keys)
    assert rb["moved"] == (0 if beta == 0 else _block_bytes(c, old_keys))


def test_a_filtered_split_is_not_prebuilt():
    a, b, c = _split_operands()
    c2 = c.copy()
    tas_multiply("N", "N", 1.0, a, b, 0.5, c, nsplit=4, filter_eps=1e-3)
    totals = mm.read_totals()
    assert totals["c_rebuild"]["prebuilt"] == 0 and "tas_c_prebuild" not in totals["regions"]
    assert totals["c_rebuild"]["rebuilt"] + totals["c_rebuild"]["kept"] == 4
    # as the groups ran before: C scaled, then each group's filtered
    # multiply into it
    scale(c2, 0.5)
    for g0 in range(0, 12, 3):
        mm.multiply("N", "N", 1.0, a, b, 1.0, c2, filter_eps=1e-3, first_row=g0,
                    last_row=g0 + 2)
    assert np.array_equal(c.keys, c2.keys)
    assert np.array_equal(port_tm.to_dense(c), port_tm.to_dense(c2))


@pytest.mark.parametrize("beta,window,kept", [
    (1.0, False, True), (1.0, True, True), (0.5, False, False), (0.5, True, False)])
def test_a_c_that_covers_the_product_keeps_its_bins_at_beta_1(beta, window, kept):
    """C already holds every key of the product: at beta 1 (a window
    scales nothing then) the kernels accumulate into C's bins, whose
    versions rise, so a canvas cached on them is built again; any other
    beta rebuilds."""
    a, b, c = _operands(seed=4)
    mm.multiply("N", "N", 1.0, a, b, 1.0, c)
    before = port_tm.to_dense(c)
    bins = [(bn.data.data_ptr(), bn.data._version, bn.data.clone()) for bn in c.bins]
    stale = mm._dense_canvas_cached(c)
    assert np.array_equal(stale.numpy(), before)
    mm.reset_totals()
    limits = dict(first_row=1, last_row=2) if window else {}
    mm.multiply("N", "N", 2.0, a, b, beta, c, **limits)
    assert mm.read_totals()["c_rebuild"] == {"rebuilt": int(not kept), "kept": int(kept),
                                             "prebuilt": 0}
    same = [bn.data.data_ptr() for bn in c.bins] == [p for p, _, _ in bins]
    assert same == kept
    if kept:  # every bin a kernel wrote reads a new version
        written = [not torch.equal(bn.data, old) for bn, (_, _, old) in zip(c.bins, bins)]
        assert any(written)
        assert all(bn.data._version > v for bn, (_, v, _), w in zip(c.bins, bins, written) if w)
        assert mm.read_totals()["rebuild_bytes"] == {"allocated": 0, "moved": 0}
    dense_ab = port_tm.to_dense(a) @ port_tm.to_dense(b)
    want = before.copy()
    rows = slice(SIZES[0], SIZES[0] + SIZES[1] + SIZES[2]) if window else slice(None)
    want[rows] = beta * before[rows] + 2.0 * dense_ab[rows]
    got = port_tm.to_dense(c)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    assert np.array_equal(mm._dense_canvas_cached(c).numpy(), got)


def test_a_kept_c_is_planned_on_its_own_binning():
    """A plan indexes C's slots: a C kept at beta 1 is launched on the
    binning it came with, which another binning of the same keys (here a
    bin's slots reversed) does not share with the rebuilt C of a beta 0.5
    product of the same fingerprint; neither reuses the other's plan."""
    rng, sizes = np.random.default_rng(4), [3, 5, 3, 5, 3]
    a, b, c = [port_tm.make_random_matrix(name, sizes, sizes, occupation=0.6, rng=rng,
                                          device="cpu") for name in "ABC"]
    mm.multiply("N", "N", 1.0, a, b, 1.0, c)
    nb, slots = c.ent_bin.copy(), c.ent_slot.copy()
    big = int(np.argmax([bn.count for bn in c.bins]))
    assert c.bins[big].count > 2
    slots[nb == big] = c.bins[big].count - 1 - slots[nb == big]
    bins = [core_matrix._Bin(bn.shape, bn.data.flip(0) if i == big else bn.data.clone(),
                             bn.count) for i, bn in enumerate(c.bins)]
    c.set_structure_from_device(c.keys.copy(), bins,
                                binning=(nb, slots, [bn.shape for bn in c.bins]))
    before, dense_ab = port_tm.to_dense(c), port_tm.to_dense(a) @ port_tm.to_dense(b)
    for beta in (0.5, 1.0):
        cx = c.copy()
        mm.multiply("N", "N", 1.0, a, b, beta, cx)
        np.testing.assert_allclose(port_tm.to_dense(cx), beta * before + dense_ab,
                                   rtol=1e-13, atol=1e-13)
    assert mm.read_totals()["plan_cache"]["hit"] == 0


def test_a_kept_c_shared_with_a_cache_is_copied_first():
    a, b, c = _operands(seed=4)
    mm.multiply("N", "N", 1.0, a, b, 1.0, c)
    held = [bn.data for bn in c.bins]
    snapshot = [d.clone() for d in held]
    c._bins_shared = True  # as the incremental cache marks the bins it holds
    mm.multiply("N", "N", 1.0, a, b, 1.0, c)
    assert mm.read_totals()["c_rebuild"] == {"rebuilt": 1, "kept": 1, "prebuilt": 0}
    assert all(torch.equal(d, s) for d, s in zip(held, snapshot))
    assert all(bn.data is not d for bn, d in zip(c.bins, held))


# --------------------------------------------------------- host to device
def test_uploads_count_their_bytes():
    idx = np.arange(7, dtype=np.int32)
    arr = np.ones((3, 2, 5), np.float64)
    t0 = mempool.transfer_totals()["h2d"]
    core_matrix.to_index(idx, torch.device("cpu"))
    assert mempool.transfer_totals()["h2d"] - t0 == np.asarray(idx, np.int64).nbytes
    core_matrix.to_device(arr, torch.float64, torch.device("cpu"))
    assert mempool.transfer_totals()["h2d"] - t0 == idx.size * 8 + arr.nbytes
    assert mm.read_totals()["h2d_bytes"] == idx.size * 8 + arr.nbytes
    mempool.reset_stats()  # a counter reset after the baseline: counted from zero
    core_matrix.to_index(idx, torch.device("cpu"))
    assert mm.read_totals()["h2d_bytes"] == idx.size * 8


def test_a_finalize_of_host_blocks_counts_its_upload():
    m = core_matrix.BlockSparseMatrix("H", SIZES, SIZES, device="cpu")
    m.put_block(1, 2, np.ones((5, 2)))
    mm.reset_totals()
    m.finalize()
    # the block's 80 bytes and the index of its slot
    assert mm.read_totals()["h2d_bytes"] == 5 * 2 * 8 + 8


# ------------------------------------------------------------- one clock
PHASE_REGIONS = {"format": "multiply_format", "index": "multiply_index",
                 "incremental": "multiply_incremental", "assemble": "multiply_c_assemble",
                 "plan": "multiply_plan", "launch": "multiply_launch",
                 "dense": "multiply_dense", "composite": "multiply_dense"}
PRODUCT_PHASES = {"stack": {"format", "index", "assemble", "plan", "launch"},
                  "dense": {"format", "dense"},
                  "incremental": {"format", "index", "incremental"}}


@pytest.fixture
def product():
    """(A, B, C, beta) for one more multiply of the kind asked: a stack
    product, a dense one, or one the incremental cache serves (after the
    runs that record and install it)."""
    prev = {k: getattr(get_config(), k) for k in ("mm_format", "incremental")}

    def make(kind):
        set_config(mm_format="dense" if kind == "dense" else "stack",
                   incremental="auto" if kind == "incremental" else "off")
        a, b, c = _operands()
        beta = 0.0 if kind == "incremental" else 0.5
        if kind == "incremental":
            for _ in range(3):
                mm.multiply("N", "N", 1.0, a, b, beta, c)
        return a, b, c, beta

    yield make
    set_config(**prev)
    _incremental.reset()


@pytest.mark.parametrize("kind", list(PRODUCT_PHASES))
def test_each_phase_is_its_regions_seconds(kind, product):
    a, b, c, beta = product(kind)
    timings.reset()
    mm.reset_totals()
    mm.multiply("N", "N", 1.0, a, b, beta, c)
    totals = mm.read_totals()
    assert totals["reused"] == (kind == "incremental")
    assert set(c._mm_phase_s) == PRODUCT_PHASES[kind]
    for name, seconds in c._mm_phase_s.items():
        assert seconds == totals["regions"][PHASE_REGIONS[name]]["seconds"] > 0, name
        assert totals["regions"][PHASE_REGIONS[name]]["calls"] == 1, name
    assert totals["host_phase_s"] == c._mm_phase_s


@pytest.mark.parametrize("kind", list(PRODUCT_PHASES))
def test_the_phases_are_timed_while_hooks_hold_the_timer(kind, product):
    a, b, c, beta = product(kind)
    mm.reset_totals()
    opened = []
    timings.set_hooks(opened.append, lambda name: None)
    try:
        mm.multiply("N", "N", 1.0, a, b, beta, c)
    finally:
        timings.set_hooks(None, None)
    assert set(c._mm_phase_s) == PRODUCT_PHASES[kind]
    assert all(seconds > 0 for seconds in c._mm_phase_s.values())
    assert {PHASE_REGIONS[name] for name in c._mm_phase_s} <= set(opened)
    assert "multiply_format" not in mm.read_totals()["regions"]


def test_the_format_and_incremental_regions_are_no_spans(tmp_path, product):
    a, b, c, beta = product("incremental")
    mm.reset_totals()
    t = tracer.enable(str(tmp_path / "trace.jsonl"))
    mm.multiply("N", "N", 1.0, a, b, beta, c)
    tracer.disable()
    spans = {e["name"]: e for e in t.events if e.get("ev") == "span"}
    assert "multiply_index" in spans
    assert not {"multiply_format", "multiply_incremental"} & set(spans)
    # the planner's attributes stay on the product's span
    assert spans["multiply"]["attrs"]["format"] == "stack"
    regions = mm.read_totals()["regions"]
    assert regions["multiply_format"]["calls"] == regions["multiply_incremental"]["calls"] == 1


# ----------------------------------------------------------------- tracer
def test_the_tracer_shares_the_profilers_clock(tmp_path):
    t = tracer.enable(str(tmp_path / "trace.jsonl"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timings.timed("clock_probe"):
            time.sleep(0.002)
    tracer.disable()
    (span,) = [e for e in t.events if e.get("ev") == "span" and e["name"] == "clock_probe"]
    (rng,) = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "dbcsr_tpu_torch:clock_probe"]
    assert abs(rng.start_ns() / 1e3 - span["ts_us"]) < 1000.0
    with open(t.chrome_path) as f:
        (ce,) = [e for e in json.load(f)["traceEvents"] if e["name"] == "clock_probe"]
    assert ce["ts"] == span["ts_us"]
    meta = t.events[0]
    assert meta["clock"] == "unix_us" and abs(meta["t0_unix"] * 1e6 - span["ts_us"]) < 60e6


def test_a_region_without_a_span_leaves_its_attributes_to_its_parent(tmp_path):
    t = tracer.enable(str(tmp_path / "trace.jsonl"))
    mm.reset_totals()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timings.timed("outer"):
            with timings.timed("part", span=False):
                tracer.annotate(x=1)
                tracer.add("n", 2)
            with timings.timed("own"):
                tracer.annotate(y=3)
    tracer.disable()
    spans = {e["name"]: e for e in t.events if e.get("ev") == "span"}
    assert "part" not in spans
    assert spans["outer"]["attrs"] == {"x": 1, "n": 2} and spans["own"]["attrs"] == {"y": 3}
    assert spans["own"]["depth"] == 1
    # still a region of the timer and a range of the profiler
    assert mm.read_totals()["regions"]["part"]["calls"] == 1
    assert [e.name() for e in prof.profiler.kineto_results.events()
            if e.name() == "dbcsr_tpu_torch:part"] == ["dbcsr_tpu_torch:part"]


def test_the_profiler_range_opens_only_under_a_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with timings.timed("quiet"):
        pass
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with timings.timed("heard"):
            pass
    assert opened == ["dbcsr_tpu_torch:heard"]
    regions = mm.read_totals()["regions"]
    assert regions["quiet"]["calls"] == regions["heard"]["calls"] == 1


def test_trace_merge_keeps_a_lone_port_shard_on_the_profilers_clock(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools"))
    import trace_merge

    t = tracer.enable(str(tmp_path / "t.jsonl"))
    with timings.timed("first"):
        pass
    time.sleep(0.01)
    with timings.timed("second"):
        pass
    tracer.disable()
    res = trace_merge.merge([t.path])
    assert res["mode"] == "t0_unix"
    ts = {e["name"]: e["ts"] for e in res["doc"]["traceEvents"] if e.get("ph") == "X"}
    spans = {e["name"]: e["ts_us"] for e in t.events if e.get("ev") == "span"}
    # merged alone, a shard keeps its stamps: the profiler's clock
    assert ts == spans
