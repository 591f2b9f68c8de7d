"""The port's mutation journal, value digests and delta-aware incremental
multiply (dbcsr_tpu_torch.core.matrix, core.digests, mm.incremental),
held against the JAX package on the CPU.

* The journal at every funnel the port has, as `tests/test_incremental.py`
  checks the JAX package's: a same-pattern finalize journals exactly the
  staged keys, a new key or `free` reads as unknown, value funnels bump
  the epoch, the journal truncates to unknown, copies never share it,
  and a restore is never "unchanged".
* The digests' conventions, and a matrix's value digest following its
  epoch.
* The incremental loop (partial deltas, then a zero delta) run in both
  packages on the same seeded operands: in each package every product
  bit for bit its ``incremental="full"`` rerun, the port's C within
  1e-12 of the JAX package's, and the reuse counters (products, reused
  and recomputed blocks, saved flops, outcomes) equal to the JAX
  package's.
* A partial delta is spliced unless one at least as large already cost
  the host more than the product's full run (``fallback_costly``).
* The kill switch, the full mode, the ``incremental`` fault site (flip
  caught by the full-product probe, raise), the breaker, and a donated
  add feeding the journal.
* Under ``precision="adaptive"`` and ``abft="verify"`` the demoted
  products are spliced: the full-product probe is held to the demotion
  ceiling of the specs C's blocks were computed at, so no mismatch is
  counted and each reuse is bit for bit the demoted full rerun.
* Copy-on-write: a multiply, a `scale`, a `put_block` and the diagonal
  writes after an install leave the cached bits untouched, and a cached
  bin written behind the journal's back is never spliced.
* The models publish one ``model_reuse`` event per step.

Every test resets both packages' incremental caches, faults, breakers,
metrics and events, and restores both configs.
"""

import numpy as np
import pytest
import torch

from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.core.matrix import BlockSparseMatrix as JaxMatrix
from dbcsr_tpu.mm import incremental as jax_inc
from dbcsr_tpu.mm.multiply import multiply as jax_multiply
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.ops import test_methods as jax_tm

from dbcsr_tpu_torch.acc import abft, precision
from dbcsr_tpu_torch.core import digests, mempool
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.mm import incremental as inc
from dbcsr_tpu_torch.mm import multiply as port_mm
from dbcsr_tpu_torch.models import make_test_density, mcweeny_purify
from dbcsr_tpu_torch.obs import events, metrics
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.ops.operations import add, add_on_diag, scale, set_diag, set_value
from dbcsr_tpu_torch.resilience import breaker, faults

_CFG = ("incremental", "abft", "mm_format", "precision")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    # the splice's mechanics are tested with every partial delta
    # admitted; the admission by observed cost has its own test
    monkeypatch.setattr(inc, "_slower_than_full", lambda ent, splice_s: False)
    jcfg = {k: getattr(jax_get_config(), k) for k in _CFG}
    pcfg = {k: getattr(get_config(), k) for k in _CFG}
    set_config(incremental="auto", mm_format="stack")
    jax_set_config(incremental="auto", mm_format="stack")
    for mod in (inc, jax_inc):
        mod.reset()
    yield
    for mod in (inc, jax_inc):
        mod.reset()
    precision.reset()
    faults.clear()
    breaker.reset_board()
    metrics.reset()
    events.clear()
    jax_metrics.reset()
    jax_events.clear()
    jax_health.reset()
    abft.discard_pending()
    port_mm.clear_plan_cache()
    jax_set_config(**jcfg)
    set_config(**pcfg)


def _mat(name, nblk=8, bsz=6, occ=0.5, seed=0):
    return port_tm.make_random_matrix(name, [bsz] * nblk, [bsz] * nblk, occupation=occ,
                                      rng=np.random.default_rng(seed), device="cpu")


# ------------------------------------------------------------------ epochs
def test_same_pattern_finalize_records_staged_keys():
    m = _mat("M")
    rows, cols = m.entry_coords()
    e0 = m.mutation_epoch
    m.put_block(int(rows[0]), int(cols[0]), np.ones((6, 6)))
    m.put_block(int(rows[2]), int(cols[2]), np.ones((6, 6)))
    m.finalize()
    assert set(m.dirty_keys_since(e0)) == {int(m.keys[0]), int(m.keys[2])}
    assert m.mutation_epoch > e0


def test_structure_change_resets_dirty_state():
    m = _mat("M")
    e0 = m.mutation_epoch
    free = next((r, c) for r in range(m.nblkrows) for c in range(m.nblkcols)
                if m._find_entry(r, c) < 0)
    m.put_block(free[0], free[1], np.ones((6, 6)))
    m.finalize()
    assert m.dirty_keys_since(e0) is None


def test_value_funnels_bump_epoch():
    m = _mat("M")
    add_on_diag(m, 1.0)  # the first call may reserve missing diagonal blocks
    n = min(m.nfullrows, m.nfullcols)
    for fn in (lambda: scale(m, 2.0), lambda: add_on_diag(m, 1.0), lambda: m.zero_data(),
               lambda: set_value(m, 0.5), lambda: set_diag(m, np.arange(n, dtype=float)),
               lambda: add(m, m.copy(), 1.0, 0.5)):
        e = m.mutation_epoch
        fn()
        assert m.mutation_epoch > e
        assert m.dirty_keys_since(e) is not None  # values only: known


def test_diag_funnels_record_only_diag_keys():
    m = _mat("M", occ=0.8)
    add_on_diag(m, 0.0)
    rows, cols = m.entry_coords()
    diag_keys = set(m.keys[rows == cols])
    for fn in (lambda: add_on_diag(m, 0.5), lambda: set_diag(m, np.ones(m.nfullrows))):
        e = m.mutation_epoch
        fn()
        assert set(m.dirty_keys_since(e)) == diag_keys


def test_journal_truncation_degrades_to_unknown():
    m = _mat("M")
    e0 = m.mutation_epoch
    for _ in range(m._DELTA_LOG_MAX + 2):
        m.zero_data()
    assert m.dirty_keys_since(e0) is None
    assert m.dirty_keys_since(m.mutation_epoch) is not None


def test_copy_never_aliases_delta_state():
    m = _mat("M")
    m2 = m.copy("M2")
    e_m, e_m2 = m.mutation_epoch, m2.mutation_epoch
    scale(m, 2.0)
    assert m2.mutation_epoch == e_m2
    scale(m2, 3.0)
    assert m.mutation_epoch == e_m + 1


def test_restore_bumps_epoch_and_marks_all_dirty():
    m = _mat("M")
    snap = mempool.snapshot_matrix(m)
    e_snap = m.mutation_epoch
    scale(m, 2.0)
    mempool.restore_matrix(snap)
    assert m.mutation_epoch > e_snap
    assert m.dirty_keys_since(e_snap) is None


def test_free_and_foreign_epochs_are_unknown():
    m = _mat("M")
    assert m.dirty_keys_since(m.mutation_epoch + 5) is None
    e0 = m.mutation_epoch
    m.free()
    assert m.dirty_keys_since(e0) is None


# ----------------------------------------------------------------- digests
def test_digest_convention():
    a = np.arange(6, dtype=np.int64)
    assert digests.host_digest(a) == digests.host_digest(a.copy())
    assert digests.host_digest(a) != digests.host_digest(a.reshape(2, 3))
    assert digests.index_digest(a, a) == digests.index_digest(a, a)
    assert digests.scalar_key(np.float64(2.0)) == digests.scalar_key(2)
    t = [torch.zeros(2), torch.ones(2)]
    assert digests.buffers_key(t) == tuple(id(x) for x in t)


def test_matrix_value_digest_tracks_epochs():
    m = _mat("M")
    d0 = digests.matrix_value_digest(m)
    assert digests.matrix_value_digest(m) == d0
    scale(m, 2.0)
    assert digests.matrix_value_digest(m) != d0
    assert digests.matrix_value_digest(_mat("M2")) == d0  # same seed, values


def test_mempool_mirror_and_free_lists():
    mempool.reset_stats()
    idx = np.arange(10, dtype=np.int32)
    x = mempool.upload_index("t", idx)
    assert mempool.upload_index("t", idx.copy()) is x  # content-keyed hit
    assert mempool.transfer_totals()["h2d"] == idx.nbytes
    buf = torch.ones((3, 4, 4))
    assert mempool.release(buf)
    z = mempool.zeros((3, 4, 4), torch.float32)
    assert z is buf and not z.any()
    st = mempool.pool_stats()
    assert (st["hits"], st["returns"]) == (1, 1)
    mempool.clear()
    assert mempool.pool_stats()["mirror_entries"] == 0


# -------------------------------------------------------- incremental loop
def _operands(seed=3, nblk=8, bsz=6):
    bs = [bsz] * nblk
    pa, pb = (port_tm.make_random_matrix(n, bs, bs, occupation=0.5,
                                         rng=np.random.default_rng(seed + i), device="cpu")
              for i, n in enumerate("AB"))
    ja, jb = (jax_tm.make_random_matrix(n, bs, bs, occupation=0.5,
                                        rng=np.random.default_rng(seed + i))
              for i, n in enumerate("AB"))
    return (pa, pb, BlockSparseMatrix("C", bs, bs, device="cpu")), \
        (ja, jb, JaxMatrix("C", bs, bs))


def _port_full(a, b):
    c = BlockSparseMatrix("Cref", a.row_blk_sizes, b.col_blk_sizes, device="cpu")
    set_config(incremental="full")
    port_mm.multiply("N", "N", 1.0, a, b, 0.0, c)
    set_config(incremental="auto")
    return port_tm.to_dense(c)


def _jax_full(a, b):
    c = JaxMatrix("Cref", a.row_blk_sizes, b.col_blk_sizes)
    jax_set_config(incremental="full")
    jax_multiply("N", "N", 1.0, a, b, 0.0, c)
    jax_set_config(incremental="auto")
    return np.asarray(jax_tm.to_dense(c))


def _counts(mod) -> dict:
    return {lab["result"]: v for lab, v in mod.counter_items("dbcsr_tpu_incremental_total")}


def _delta(m, it, dirty=2):
    rows, cols = m.entry_coords()
    blocks = np.random.default_rng(100 + it).standard_normal((dirty, 6, 6))
    m.put_blocks(rows[:dirty], cols[:dirty], blocks)
    m.finalize()


def test_incremental_loop_bitwise_and_counted_like_jax():
    """Partial deltas, then a zero delta, in both packages: each product
    bit for bit its full rerun, C within 1e-12 of the JAX package's, and
    the same reuse totals and outcomes."""
    (pa, pb, pc), (ja, jb, jc) = _operands()
    jax_metrics.reset()
    for it in range(7):
        if 0 < it < 6:
            _delta(pa, it)
            _delta(ja, it)
        port_mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc)
        jax_multiply("N", "N", 1.0, ja, jb, 0.0, jc)
        got = port_tm.to_dense(pc)
        np.testing.assert_array_equal(got, _port_full(pa, pb))
        want = np.asarray(jax_tm.to_dense(jc))
        np.testing.assert_array_equal(want, _jax_full(ja, jb))
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    st, jst = inc.stats_snapshot(), jax_inc.stats_snapshot()
    assert st == jst
    assert st["products"] == 4 and st["reused_blocks"] > 0 and st["saved_flops"] > 0
    counts = _counts(metrics)
    assert counts.get("hit_splice") == 3 and counts.get("hit_unchanged") == 1
    jcounts = _counts(jax_metrics)
    assert {k: counts.get(k) for k in ("hit_splice", "hit_unchanged")} == \
        {k: jcounts.get(k) for k in ("hit_splice", "hit_unchanged")}
    assert port_mm.read_totals()["reused"] >= 4


def test_incremental_zero_delta_adopts_the_cache():
    (pa, pb, pc), _ = _operands()
    for _ in range(3):
        port_mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc)
    ref = _port_full(pa, pb)
    p0 = inc.stats_snapshot()["products"]
    port_mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc)
    assert inc.stats_snapshot()["products"] == p0 + 1
    np.testing.assert_array_equal(port_tm.to_dense(pc), ref)
    assert pc._bins_shared and pc._mm_plan_cache is None


@pytest.mark.parametrize("mode", ["off", "full"])
def test_incremental_off_and_full_never_splice(mode):
    set_config(incremental=mode)
    (pa, pb, pc), _ = _operands()
    for it in range(5):
        if it:
            _delta(pa, it)
        port_mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc)
    assert inc.stats_snapshot()["products"] == 0
    assert (inc.cache_snapshot()["entries"] == 0) == (mode == "off")


def _warm(dirty_it=1):
    (pa, pb, pc), _ = _operands()
    for it in range(4):
        if it:
            _delta(pa, it + dirty_it * 10)
        port_mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc)
    return pa, pb, pc


def test_incremental_flip_fault_forces_full_recompute():
    set_config(abft="verify")
    pa, pb, pc = _warm()
    _delta(pa, 9)
    ref = _port_full(pa, pb)
    with faults.inject_faults("incremental:flip,times=1") as specs:
        port_mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc)
    assert specs[0].fired
    np.testing.assert_array_equal(port_tm.to_dense(pc), ref)
    assert _counts(metrics).get("fallback_abft", 0) >= 1
    assert metrics.counter_items("dbcsr_tpu_abft_recoveries_total") == [
        ({"driver": "incremental"}, 1.0)]


def test_incremental_raise_fault_falls_back():
    pa, pb, pc = _warm()
    _delta(pa, 11)
    with faults.inject_faults("incremental:raise,times=1") as specs:
        port_mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc)
    assert specs[0].fired
    np.testing.assert_array_equal(port_tm.to_dense(pc), _port_full(pa, pb))
    assert _counts(metrics).get("fallback_fault") == 1


def test_incremental_breaker_degrades_after_repeated_failures():
    set_config(abft="verify")
    pa, pb, pc = _warm()
    with faults.inject_faults("incremental:flip"):
        for it in range(inc._BREAKER_THRESHOLD + 1):
            _delta(pa, 50 + it)
            port_mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc)
    assert inc._breaker["open"]
    assert events.records(kind="incremental_degrade")
    np.testing.assert_array_equal(port_tm.to_dense(pc), _port_full(pa, pb))


def test_adaptive_verify_splices_demoted_products(monkeypatch, tmp_path):
    # empty tables: a tuned host row would outrank adaptive demotion
    monkeypatch.setenv("DBCSR_TPU_TORCH_PARAMS_DIR", str(tmp_path))
    set_config(precision="adaptive", abft="verify")
    (pa, pb, pc), _ = _operands()
    for it in range(7):
        if it in (3, 5):
            _delta(pa, it)
        port_mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc)
        np.testing.assert_array_equal(port_tm.to_dense(pc), _port_full(pa, pb))
    counts = _counts(metrics)
    assert (counts.get("hit_unchanged"), counts.get("hit_splice")) == (2, 2), counts
    assert metrics.counter_items("dbcsr_tpu_abft_mismatches_total") == []
    assert metrics.counter_items("dbcsr_tpu_abft_recoveries_total") == []
    assert not inc._breaker["open"] and inc._breaker["failures"] == 0
    assert sum(v for _, v in metrics.counter_items("dbcsr_tpu_precision_launches_total")) > 0
    ent = next(iter(inc._cache.values()))
    assert ent.precisions == {("float32", False)}


def test_partial_splice_that_lost_is_not_retried_at_its_size(monkeypatch):
    """A partial splice slower on the host than the product's full run
    marks its size: a delta at least as large recomputes in full
    (``fallback_costly``), a smaller one is tried, a zero delta is always
    reused; C is bit for bit the full product throughout."""
    monkeypatch.setattr(inc, "_slower_than_full", lambda ent, splice_s: True)
    pa, pb, pc = _warm()
    assert next(iter(inc._cache.values())).full_s > 0
    inc._lost_at.clear()  # the warm-up's own splices lost too
    outcomes = []
    for it, dirty in enumerate((2, 2, 1, 0)):
        if dirty:
            _delta(pa, 70 + it, dirty=dirty)
        before = _counts(metrics)
        port_mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc)
        np.testing.assert_array_equal(port_tm.to_dense(pc), _port_full(pa, pb))
        after = _counts(metrics)
        outcomes.append(next(k for k in after if after[k] != before.get(k, 0)
                             and k != "forced_full"))
    assert outcomes == ["hit_splice", "fallback_costly", "hit_splice", "hit_unchanged"]
    assert len(inc._lost_at) == 1


def test_incremental_after_add_stays_correct():
    pa, pb, pc = _warm()
    same = _mat("B2", seed=4)
    if np.array_equal(same.keys, pb.keys):
        add(pb, same, 1.0, 0.25)
    else:
        scale(pb, 1.25)
    port_mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc)
    np.testing.assert_array_equal(port_tm.to_dense(pc), _port_full(pa, pb))


# ----------------------------------------------------------- copy-on-write
def _cached_bits():
    ent = next(iter(inc._cache.values()))
    return [(d, d.clone()) for _, d, _ in ent.bins]


def test_cached_result_survives_in_place_writes():
    """The cache aliases C's bins: a `scale`, the diagonal writes, a
    `put_block` and another multiply into C after the install leave the
    cached bits as they were, and the next zero-delta reuse serves the
    right product."""
    pa, pb, pc = _warm()
    assert inc.cache_snapshot()["entries"] == 1 and pc._bins_shared
    held = _cached_bits()
    scale(pc, 3.0)
    add_on_diag(pc, 1.0)
    set_value(pc, 0.25)
    rows, cols = pc.entry_coords()
    pc.put_block(int(rows[0]), int(cols[0]), np.ones((6, 6)))
    pc.finalize()
    other = BlockSparseMatrix("C2", pc.row_blk_sizes, pc.col_blk_sizes, device="cpu")
    port_mm.multiply("N", "N", 2.0, pb, pa, 0.0, other)
    port_mm.multiply("N", "N", 1.0, pa, pa, 0.5, pc)  # beta != 0: reads, rebuilds
    for live, before in held:
        assert torch.equal(live, before)
    c = BlockSparseMatrix("C", pc.row_blk_sizes, pc.col_blk_sizes, device="cpu")
    port_mm.multiply("N", "N", 1.0, pa, pb, 0.0, c)
    np.testing.assert_array_equal(port_tm.to_dense(c), _port_full(pa, pb))


def test_written_cache_entry_is_never_spliced():
    """A cached bin written in place behind the journal (its version
    counter moved) drops the entry: the product recomputes in full."""
    pa, pb, pc = _warm()
    ent = next(iter(inc._cache.values()))
    ent.bins[0][1].add_(1.0)  # a write no funnel saw
    port_mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc)
    np.testing.assert_array_equal(port_tm.to_dense(pc), _port_full(pa, pb))
    assert _counts(metrics).get("fallback_epoch") == 1


def test_oversized_result_is_never_cached(monkeypatch):
    monkeypatch.setattr(inc, "_CACHE_MAX_BYTES", 64)
    pa, pb, pc = _warm()
    assert inc.cache_snapshot()["entries"] == 0 and not pc._bins_shared
    assert inc.stats_snapshot()["products"] == 0


def test_canvas_format_drops_entries():
    pa, pb, pc = _warm()
    assert inc.cache_snapshot()["entries"] == 1
    set_config(mm_format="dense")
    port_mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc.copy())
    assert inc.cache_snapshot()["entries"] == 0


def test_models_publish_reuse_events():
    p = make_test_density(6, 4, occ=0.4, seed=0, device="cpu")
    mcweeny_purify(p, steps=2)
    evs = events.records(kind="model_reuse")
    assert len(evs) == 2 and all("reuse_fraction" in e for e in evs)
    assert inc.reuse_delta(inc.stats_snapshot())["reuse_fraction"] == 0.0
