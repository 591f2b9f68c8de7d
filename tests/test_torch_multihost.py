"""The port's multi-process world (`parallel/multihost.py`) on the CPU.

After `tests/test_multihost.py` and `tests/test_multihost_2proc.py`:

* The serial stub (ref `dbcsr_mpiwrap.F:130-150`): one process, no
  world to join, `init_multihost()` returns False quietly; an explicit
  join that fails other than by timing out raises; one that times out
  returns False with a counted, flight-recorded degraded-to-serial note;
  the ``multihost_init`` fault site fires at the join.
* A real world: two spawned processes over gloo (a ``file://``
  rendezvous), two images each, one 1x2x2 grid.  It runs a sparse
  Cannon and `run_perf` on `test_square_sparse_rma.perf`; every rank
  returns the same checksum and C's values equal, bit for bit, the
  one-process 1x2x2 grid's; the panels crossed ranks host-staged.  Each
  world runs under its own timeout (150 s), so a hung rendezvous fails
  its test, not the suite.
"""

import os

import numpy as np
import pytest
import torch

from dbcsr_tpu_torch.core import timings
from dbcsr_tpu_torch.core.digests import matrix_value_digest
from dbcsr_tpu_torch.obs import flight, metrics
from dbcsr_tpu_torch.ops.test_methods import checksum, make_random_matrix
from dbcsr_tpu_torch.parallel import make_grid, multihost, sparse_multiply_distributed
from dbcsr_tpu_torch.perf.driver import (
    aggregate_rank_results,
    parse_perf_file,
    run_perf,
    run_perf_multiproc,
)
from dbcsr_tpu_torch.resilience import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RMA = os.path.join(ROOT, "tests", "inputs", "test_square_sparse_rma.perf")
WORLD_TIMEOUT_S = 150
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    metrics.reset()
    flight.clear()
    yield
    faults.clear()
    metrics.reset()


def test_serial_stub_semantics():
    assert multihost.process_count() == 1
    assert multihost.process_id() == 0
    assert multihost.is_coordinator()
    multihost.shutdown_multihost()  # no world: a no-op


def test_auto_join_without_cluster_returns_false(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_multihost() is False
    assert multihost.process_count() == 1


def test_explicit_join_failure_propagates(monkeypatch):
    import torch.distributed as dist

    def boom(**kw):
        raise RuntimeError("no coordinator")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="no coordinator"):
        multihost.init_multihost("localhost:1", 2, 0, timeout_s=1)


def test_join_timeout_degrades_to_serial(monkeypatch):
    import torch.distributed as dist

    def wedged(**kw):
        raise RuntimeError("Timed out after 1 seconds waiting for clients")

    monkeypatch.setattr(dist, "init_process_group", wedged)
    with pytest.warns(RuntimeWarning, match="DEGRADING TO SERIAL"):
        assert multihost.init_multihost("file:///nonexistent/x", 2, 0, timeout_s=1) is False
    items = metrics.counter_items("dbcsr_tpu_multihost_degraded_total")
    assert [(lab["reason"], v) for lab, v in items] == [("join_timeout", 1)]
    rec = flight.records()[-1]
    assert rec["op"] == "multihost_init" and "degraded to serial" in rec["error"]


def test_multihost_init_fault_site():
    with faults.inject_faults("multihost_init:raise,times=1") as installed:
        with pytest.raises(RuntimeError):
            multihost.init_multihost("file:///nonexistent/x", 2, 0, timeout_s=1)
    assert sum(s.fired for s in installed) == 1


def test_multihost_grid_single_process_runs_cannon():
    g = multihost.make_multihost_grid(images_per_process=8, device="cpu")
    assert g.axis_names == ("kl", "pr", "pc") and g.size == 8
    rng = np.random.default_rng(5)
    sizes = [3] * 8
    a = make_random_matrix("A", sizes, sizes, occupation=0.5, rng=rng, device="cpu")
    b = make_random_matrix("B", sizes, sizes, occupation=0.5, rng=rng, device="cpu")
    c = sparse_multiply_distributed(1.0, a, b, 0.0, None, g)
    from dbcsr_tpu_torch.ops.test_methods import to_dense

    np.testing.assert_allclose(to_dense(c), to_dense(a) @ to_dense(b), rtol=1e-12, atol=1e-12)


def test_timings_report_aggregate_in_one_process_is_the_plain_table():
    timings.reset()
    with timings.timed("outer"):
        pass
    plain, agg = [], []
    timings.report(out=plain.append)
    timings.report(out=agg.append, aggregate=True)
    assert plain == agg and any("outer" in line for line in plain)
    timings.reset()


def test_aggregate_rank_results():
    rows = [{"checksum": 1.5, "flops": 100, "time_best_s": 2.0, "gflops_mean": 1.0},
            {"checksum": 1.5, "flops": 100, "time_best_s": 4.0, "gflops_mean": 3.0}]
    agg = aggregate_rank_results(rows)
    assert agg["nproc"] == 2 and agg["gflops_world"] == 100 / 4.0 / 1e9
    assert agg["gflops_mean_ranks"] == 2.0
    with pytest.raises(RuntimeError, match="differ"):
        aggregate_rank_results([rows[0], dict(rows[1], checksum=2.5)])


def test_two_process_world_sparse_cannon_matches_one_process_bits():
    results = multihost.spawn_world("dbcsr_tpu_torch.parallel.multihost:sparse_cannon_task",
                                    2, (9, 8, 3, 0.5, 2, "cpu"), timeout_s=WORLD_TIMEOUT_S)
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["grid"] == {"kl": 1, "pr": 2, "pc": 2} for r in results)
    assert len({r["checksum"] for r in results}) == 1
    assert len({r["digest"] for r in results}) == 1
    for r in results:
        assert r["staged"]["shift"]["bytes"] > 0 and r["staged"]["shift"]["messages"] > 0
        assert r["staged"]["gather"]["bytes"] > 0
    assert results[0]["mode"] == "double_buffer"
    # the one-process 1x2x2 grid on the same operands: the same bits
    rng = np.random.default_rng(9)
    a = make_random_matrix("A", [3] * 8, [3] * 8, occupation=0.5, rng=rng, device="cpu")
    b = make_random_matrix("B", [3] * 8, [3] * 8, occupation=0.5, rng=rng, device="cpu")
    c = sparse_multiply_distributed(1.0, a, b, 0.0, None, make_grid(4, devices=[CPU] * 4))
    assert checksum(c) == results[0]["checksum"]
    assert matrix_value_digest(c).hex() == results[0]["digest"]
    # the rank-aggregated timing table, on the coordinator only
    text = "\n".join(results[0]["report"])
    assert "2 ranks" in text and "SELF avg" in text and "sparse_cannon" in text
    assert not results[1]["report"]


def test_two_process_world_run_perf_matches_one_process():
    agg = run_perf_multiproc(RMA, 2, images_per_proc=2, nrep=1, timeout=WORLD_TIMEOUT_S,
                             verbose=False, device="cpu")
    assert agg["nproc"] == 2
    assert len({r["digest"] for r in agg["per_rank"]}) == 1
    cfg = parse_perf_file(RMA)
    cfg.nrep = 1
    one = run_perf(cfg, verbose=False, grid=make_grid(4, devices=[CPU] * 4))
    assert agg["checksum"] == one["checksum"]
    assert agg["per_rank"][0]["digest"] == matrix_value_digest(one["matrices"]["c_out"]).hex()
    assert agg["per_rank"][0]["grid"] == {"kl": 1, "pr": 2, "pc": 2}
