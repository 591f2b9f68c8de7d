"""The multiply's plan cache in the port, on the CPU.

A repeat of a same-pattern product must hit the cache and give C bit for
bit as an uncached run does (and agree with the JAX package's multiply
at relative 1e-12 in f64, 1e-5 in f32); anything planning reads (the
config, the tuned table's generation, the dtypes, C's kind,
``retain_sparsity``, and for a filtered product the survivors) must
miss; the LRU evicts by the bytes the plans pin, each entry charged at
least a fixed floor, which bounds the count too; the TAS split's groups
repeat their keys from call to call, however many; with the residency
knob off a filtered product is not cached.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.mm.multiply import multiply as jax_multiply
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries
from dbcsr_tpu.ops import test_methods as jax_tm

from dbcsr_tpu_torch.acc import params, smm
from dbcsr_tpu_torch.core import mempool
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.ops import operations as pops
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.tas import tas_multiply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = np.array([2, 3, 5, 3, 4, 2])


@pytest.fixture(autouse=True)
def reset_jax_health():
    """The JAX package's runs in these tests feed its metrics, health
    model, events and telemetry store: all four are reset after every
    test, so a later file in the same worker (`tests/test_tune.py`'s
    admission checks) does not start from a DEGRADED or CRITICAL
    verdict."""
    yield
    for reset in (jax_metrics.reset, jax_health.reset, jax_events.clear, jax_timeseries.reset):
        reset()


@pytest.fixture(autouse=True)
def fresh_cache():
    """An empty cache, zeroed totals, and the config and knob restored."""
    cfg = get_config()
    prev = {"mm_driver": cfg.mm_driver, "validate_kernels": cfg.validate_kernels}
    pool = mempool.enabled()
    mm.clear_plan_cache()
    mm.reset_totals()
    yield
    set_config(**prev)
    mempool.set_enabled(pool)
    mm.clear_plan_cache()


def operands(seed=1, dtype=np.float64, occ=(0.6, 0.6, 0.3), kinds="NNN", sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [port_tm.make_random_matrix(name, sizes, sizes, dtype=dtype, occupation=o,
                                       matrix_type=kind, rng=rng, device="cpu")
            for name, o, kind in zip("ABC", occ, kinds)]


def run(a, b, c, beta=0.5, **kw):
    """C' = 0.7 A B + beta C into a copy of ``c``; returns (C', outcome)."""
    out = c.copy()
    mm.multiply("N", "N", 0.7, a, b, beta, out, **kw)
    return out, out._mm_plan_cache


def assert_bitwise(x, y):
    assert np.array_equal(x.keys, y.keys)
    assert len(x.bins) == len(y.bins)
    for bx, by in zip(x.bins, y.bins):
        assert torch.equal(bx.data, by.data)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_repeat_hits_and_equals_an_uncached_run(dtype):
    a, b, c = operands(dtype=dtype)
    first, o1 = run(a, b, c)
    hit, o2 = run(a, b, c)
    mm.clear_plan_cache()
    uncached, o3 = run(a, b, c)
    assert (o1, o2, o3) == ("miss", "hit", "miss")
    assert_bitwise(hit, uncached)
    assert_bitwise(first, uncached)
    totals = mm.read_totals()
    assert totals["multiplies"] == 3
    assert totals["plan_cache"] == {"hit": 1, "miss": 2, "uncacheable": 0}
    assert totals["stack_device_s"] is None  # no CUDA events on the CPU
    # the same product in the JAX package
    prev = jax_get_config().mm_driver
    jax_set_config(mm_driver="xla")
    try:
        rng = np.random.default_rng(1)
        ja, jb, jc = [jax_tm.make_random_matrix(name, SIZES, SIZES, dtype=dtype, occupation=o,
                                                rng=rng)
                      for name, o in zip("ABC", (0.6, 0.6, 0.3))]
        jax_multiply("N", "N", 0.7, ja, jb, 0.5, jc)
    finally:
        jax_set_config(mm_driver=prev)
    want = jax_tm.to_dense(jc).astype(np.float64)
    rtol = 1e-12 if dtype == np.float64 else 1e-5
    assert np.max(np.abs(port_tm.to_dense(hit) - want)) <= rtol * np.max(np.abs(want))


def test_plans_hold_int32_indices_only():
    a, b, c = operands()
    run(a, b, c)
    (entry,) = mm._plan_cache.values()
    assert entry.nbytes == sum(sp.plan.nbytes() for sp in entry.spans) > 0
    for sp in entry.spans:
        for name in smm.StackPlan.__slots__:
            value = getattr(sp.plan, name)
            if isinstance(value, torch.Tensor):
                assert value.dtype == torch.int32, name


def _change_config(name):
    if name == "mm_driver":
        set_config(mm_driver="torch")
    elif name == "validate_kernels":
        set_config(validate_kernels=False)
    else:
        params.invalidate()


@pytest.mark.parametrize("change", ["mm_driver", "validate_kernels", "params_generation"])
def test_a_planning_input_changed_misses(change):
    a, b, c = operands(seed=2)
    assert [run(a, b, c)[1] for _ in range(2)] == ["miss", "hit"]
    _change_config(change)
    assert [run(a, b, c)[1] for _ in range(2)] == ["miss", "hit"]


def test_dtype_c_kind_and_retain_sparsity_miss():
    a, b, c = operands(seed=3)
    assert [run(a, b, c)[1] for _ in range(2)] == ["miss", "hit"]
    a32, b32, c32 = operands(seed=3, dtype=np.float32)
    assert run(a32, b32, c32)[1] == "miss"
    assert run(a, b, c, retain_sparsity=True)[1] == "miss"
    # a symmetric C: same operands, C of the other kind and empty
    cs = BlockSparseMatrix("C", SIZES, SIZES, matrix_type="S", device="cpu")
    cn = BlockSparseMatrix("C", SIZES, SIZES, device="cpu")
    assert cs.pattern_fingerprint() == cn.pattern_fingerprint()
    assert run(a, b, cn, beta=0.0)[1] == "miss"
    assert run(a, b, cs, beta=0.0)[1] == "miss"
    assert run(a, b, cs, beta=0.0)[1] == "hit"


def _eps_between(a, b):
    """A filter eps that keeps about half of A B's block products."""
    i, j, a_ent, b_ent = mm._candidates(a, b, None)
    prods = a.block_norms()[a_ent] * b.block_norms()[b_ent] * np.diff(a.row_ptr).max()
    return float(np.median(prods))


def test_filtered_survivors_key_the_plan():
    a, b, c = operands(seed=4, occ=(0.8, 0.8, 0.3))
    eps = _eps_between(a, b)
    first, o1 = run(a, b, c, filter_eps=eps)
    _, o2 = run(a, b, c, filter_eps=eps)
    assert (o1, o2) == ("miss", "hit")
    # new values, the same survivors: still a hit
    pops.scale(a, 1.0 + 1e-9)
    assert run(a, b, c, filter_eps=eps)[1] == "hit"
    # another eps misses, whatever survives
    assert run(a, b, c, filter_eps=eps * 2)[1] == "miss"
    # the same pattern with values that let more products through misses,
    # and C is what an uncached run gives
    pops.scale(a, 10.0)
    grown, o3 = run(a, b, c, filter_eps=eps)
    assert o3 == "miss"
    mm.clear_plan_cache()
    uncached, _ = run(a, b, c, filter_eps=eps)
    assert_bitwise(grown, uncached)
    assert grown.nblks >= first.nblks


def test_pool_off_makes_filtered_products_uncacheable():
    a, b, c = operands(seed=5)
    mempool.set_enabled(False)
    assert [run(a, b, c, filter_eps=1e-3)[1] for _ in range(2)] == ["uncacheable"] * 2
    assert [run(a, b, c)[1] for _ in range(2)] == ["miss", "hit"]  # unfiltered: cached
    assert mm.read_totals()["plan_cache"] == {"hit": 1, "miss": 1, "uncacheable": 2}


def test_pool_env_switch():
    code = "from dbcsr_tpu_torch.core import mempool; print(mempool.enabled())"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    outs = []
    for value in ("0", "1"):
        env["DBCSR_TPU_TORCH_POOL"] = value
        outs.append(subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                                   capture_output=True, text=True, timeout=300).stdout.strip())
    assert outs == ["False", "True"]


def test_eviction_by_count(monkeypatch):
    """More distinct products than the JAX package's 16 all stay resident
    and hit on repeat; once the per-entry floor fills the budget, the
    least recent goes first."""
    b = operands(seed=6)[1]
    c = BlockSparseMatrix("C", SIZES, SIZES, device="cpu")
    mats = [operands(seed=100 + s, occ=(0.5, 0.5, 0.3))[0] for s in range(21)]
    assert len({m.pattern_fingerprint() for m in mats}) == len(mats)
    held, extra = mats[:-1], mats[-1]
    for m in held:
        assert run(m, b, c)[1] == "miss"
    assert mm.read_totals()["plan_cache_resident"]["entries"] == len(held)
    assert [run(m, b, c)[1] for m in held] == ["hit"] * len(held)
    assert mm.read_totals()["plan_evictions"]["entries"] == 0
    # a budget the floor fills at len(held) entries
    assert all(e.nbytes < mm._PLAN_ENTRY_FLOOR for e in mm._plan_cache.values())
    monkeypatch.setattr(mm, "_PLAN_CACHE_MAX_BYTES", len(held) * mm._PLAN_ENTRY_FLOOR)
    assert run(extra, b, c)[1] == "miss"
    assert len(mm._plan_cache) == len(held)
    assert run(extra, b, c)[1] == "hit"
    assert run(held[0], b, c)[1] == "miss"  # the least recent went first
    assert run(held[-1], b, c)[1] == "hit"
    ev = mm.read_totals()["plan_evictions"]
    assert ev["entries"] == 2 and ev["bytes"] == 0


def test_eviction_by_bytes(monkeypatch):
    a, b, c = operands(seed=7)
    a2 = operands(seed=8)[0]
    run(a, b, c)
    one = mm._plan_cache_bytes
    assert one > 0
    monkeypatch.setattr(mm, "_PLAN_CACHE_MAX_BYTES", one + 1)
    run(a2, b, c)
    assert len(mm._plan_cache) == 1
    assert mm._plan_cache_bytes == sum(e.nbytes for e in mm._plan_cache.values())
    assert run(a2, b, c)[1] == "hit"
    assert run(a, b, c)[1] == "miss"


def test_tas_groups_past_sixteen_hit_on_the_next_call():
    """A TAS split into 20 groups, called twice into fresh Cs with new
    values in B: the groups' keys repeat, so every lookup of the second
    call hits, and its C is the same call's on a cleared cache."""
    rng = np.random.default_rng(11)
    rows = rng.integers(2, 4, 40)
    a = port_tm.make_random_matrix("A", rows, SIZES, occupation=0.5, rng=rng, device="cpu")
    b = port_tm.make_random_matrix("B", SIZES, SIZES, occupation=0.6, rng=rng, device="cpu")

    def call():
        c = BlockSparseMatrix("C", rows, SIZES, device="cpu")
        tas_multiply("N", "N", 1.0, a, b, 0.0, c, nsplit=20)
        return c

    call()
    groups = mm.read_totals()["plan_cache"]["miss"]
    assert groups == 20
    pops.scale(b, -1.3)
    mm.reset_totals()
    warm = call()
    totals = mm.read_totals()
    assert totals["plan_cache"] == {"hit": groups, "miss": 0, "uncacheable": 0}
    assert totals["plan_cache_resident"]["entries"] >= groups
    assert totals["plan_evictions"] == {"entries": 0, "bytes": 0, "pinned_bytes": 0}
    mm.clear_plan_cache()
    cold = call()
    assert_bitwise(warm, cold)
    want = port_tm.to_dense(a) @ port_tm.to_dense(b)
    np.testing.assert_allclose(port_tm.to_dense(warm), want, rtol=1e-12, atol=1e-12)


def test_aliasing_operands_and_c(monkeypatch):
    """``multiply(p, p, p2)`` and C aliasing A: the copy of an operand
    has the original's fingerprint, so the repeats hit."""
    p = operands(seed=9, kinds="SNN")[0]
    assert p.copy().pattern_fingerprint() == p.pattern_fingerprint()
    p2 = BlockSparseMatrix("P2", SIZES, SIZES, device="cpu")
    outcomes = [run(p, p, p2, beta=0.0)[1] for _ in range(2)]
    assert outcomes == ["miss", "hit"]
    sq = run(p, p, p2, beta=0.0)[0]
    # C aliasing A: C <- C P twice from the same start
    results = []
    for _ in range(2):
        c = sq.copy()
        mm.multiply("N", "N", 1.0, c, p, 0.0, c)
        results.append((c, c._mm_plan_cache))
    assert [o for _, o in results] == ["miss", "hit"]
    assert_bitwise(results[0][0], results[1][0])
    want = port_tm.to_dense(sq) @ port_tm.to_dense(p)
    np.testing.assert_allclose(port_tm.to_dense(results[1][0]), want, rtol=1e-12, atol=1e-12)


def test_a_hit_validates_each_new_kernel_shape_once(monkeypatch):
    """First-use validation stays keyed by kernel shape: a hit neither
    skips it for a shape not yet validated nor repeats it."""
    calls = []
    real = smm._validate_kernel
    monkeypatch.setattr(smm, "_validate_kernel",
                        lambda *args: (calls.append(args[3]), real(*args)))
    monkeypatch.setattr(smm, "_validated_kernels", set())
    a, b, c = operands(seed=10)
    run(a, b, c)
    shapes = {(sp.m, sp.n, sp.k) for sp in mm._plan_cache[next(iter(mm._plan_cache))].spans}
    assert len(calls) == len(shapes) > 1
    assert run(a, b, c)[1] == "hit"
    assert len(calls) == len(shapes)  # not repeated
    smm._validated_kernels.clear()
    assert run(a, b, c)[1] == "hit"
    assert len(calls) == 2 * len(shapes)  # the cached plans kept their prefixes
