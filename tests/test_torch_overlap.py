"""The port's double-buffered tick pipeline (`parallel/overlap.py`) on the
CPU: the cases of `tests/test_overlap.py`.

* The knob and the mode policy, as in the JAX package.
* Bitwise identity of the double-buffered and the serial order on every
  route (dense Cannon, square sparse Cannon, the all-gather pipeline of
  rectangular grids, grouped TAS), with beta, filtering and layers.
* The measured-overlap plumbing under ``DBCSR_TPU_TORCH_SYNC_TIMING=1``
  and the modeled gauges, labeled by engine.
* Resilience: a fault at ``mesh_shift``, ``gather_chunk`` or
  ``tas_tick`` (raise, nan, oom) is counted, recorded against the
  pipeline's breaker, and the product is recovered bit for bit in the
  serial order; a ``collective`` fault raises before any panel moves
  and a retry gives the clean bits; a silent flip in a shifted panel is
  caught by the ABFT shift probe under ``abft="verify"`` and recovered
  bit for bit.
* The tick cost models and the shift probes against the JAX package's
  functions (equal values for the same kind and inputs).

Grids are CPU images (``devices=[cpu] * n``); the tick stacks run the
acc layer's plain versions.  Bit-for-bit comparisons use
`torch.equal` on C's bins.
"""

import numpy as np
import pytest
import torch

from dbcsr_tpu.acc import abft as jax_abft
from dbcsr_tpu.obs import costmodel as jax_costmodel
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries

from dbcsr_tpu_torch.acc import abft
from dbcsr_tpu_torch.core import stats
from dbcsr_tpu_torch.core.config import Config, get_config, set_config
from dbcsr_tpu_torch.obs import costmodel, events, flight, metrics
from dbcsr_tpu_torch.ops.test_methods import make_random_matrix, to_dense
from dbcsr_tpu_torch.parallel import (
    cannon_multiply_dense,
    make_grid,
    sparse_multiply_distributed,
    tas_grouped_multiply,
)
from dbcsr_tpu_torch.parallel import overlap as ovl
from dbcsr_tpu_torch.parallel.sparse_dist import clear_mesh_plans
from dbcsr_tpu_torch.resilience import breaker, faults


@pytest.fixture(autouse=True)
def reset_jax_health():
    """The JAX products of these tests feed the JAX package's metrics,
    health model and telemetry store (their first compiles read as a
    recompile storm, their samples as a burning roofline objective): a
    later file in the same process must not inherit a DEGRADED verdict."""
    yield
    for reset in (jax_metrics.reset, jax_health.reset, jax_timeseries.reset):
        reset()


CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _restore():
    prev = {k: getattr(get_config(), k) for k in ("cannon_overlap", "abft", "incremental")}
    faults.clear()
    breaker.reset_board()
    metrics.reset()
    events.clear()
    flight.clear()
    stats.reset()
    yield
    set_config(**prev)
    faults.clear()
    breaker.reset_board()
    metrics.reset()
    events.clear()
    flight.clear()
    stats.reset()
    clear_mesh_plans()


def _grid(n, layers=None):
    return make_grid(n, devices=[CPU] * n, layers=layers)


def _rand(name, occ=0.6, bs=(3, 5, 4, 2, 6, 3), seed=3, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return make_random_matrix(name, list(bs), list(bs), dtype=dtype, occupation=occ,
                              rng=rng, device="cpu")


def _mesh_ab(grid, mode, a, b, c0=None, alpha=2.0, beta=0.5, **kw):
    set_config(cannon_overlap=mode)
    clear_mesh_plans()
    return sparse_multiply_distributed(alpha, a, b, beta if c0 is not None else 0.0,
                                       c0, grid, **kw)


def _same(x, y) -> bool:
    return np.array_equal(x.keys, y.keys) and all(
        torch.equal(p.data, q.data) for p, q in zip(x.bins, y.bins))


def _ctr(name, **labels) -> float:
    return sum(v for lab, v in metrics.counter_items(name)
               if all(lab.get(k) == x for k, x in labels.items()))


# ----------------------------------------------------------------- knob
def test_knob_validation():
    with pytest.raises(ValueError, match="cannon_overlap"):
        set_config(cannon_overlap="pipelined")
    assert get_config().cannon_overlap in ("auto", "double_buffer", "serial")
    for v in ("auto", "double_buffer", "serial"):
        Config(cannon_overlap=v).validate()
    with pytest.raises(ValueError):
        Config(cannon_overlap="SERIAL").validate()


def test_resolve_mode_policy():
    set_config(cannon_overlap="auto")
    assert ovl.resolve_mode("mesh", "1x2x2", 2)[0] == "double_buffer"
    assert ovl.resolve_mode("mesh", "1x1x1", 1) == ("serial", "no-ring-shifts")
    assert ovl.resolve_mode("mesh", "1x2x3", 3, nticks=1) == ("serial", "no-ring-shifts")
    set_config(cannon_overlap="serial")
    assert ovl.resolve_mode("mesh", "1x2x2", 2) == ("serial", "config")
    set_config(cannon_overlap="double_buffer")
    assert ovl.resolve_mode("mesh", "1x2x2", 2) == ("double_buffer", "config")
    assert not ovl.use_split_pipeline("serial", "config", False)
    assert ovl.use_split_pipeline("serial", "config", True)
    assert not ovl.use_split_pipeline("serial", "breaker-open", True)


# ----------------------------------------------- bitwise identity, by route
def test_dense_cannon_bitwise_identity():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 16))
    b = rng.standard_normal((16, 12))
    g = _grid(8)
    set_config(cannon_overlap="serial")
    c_ser = cannon_multiply_dense(g, a, b)
    set_config(cannon_overlap="double_buffer")
    c_db = cannon_multiply_dense(g, a, b)
    assert torch.equal(c_ser, c_db)
    np.testing.assert_allclose(c_db.numpy(), a @ b, rtol=1e-12)


@pytest.mark.parametrize("n,layers", [(4, None), (8, None), (6, None), (4, 2)],
                         ids=["1x2x2", "2x2x2", "1x2x3", "2x1x2"])
def test_sparse_routes_bitwise_identity(n, layers):
    g = _grid(n, layers)
    a, b, c0 = _rand("A"), _rand("B", seed=4), _rand("C", occ=0.3, seed=5)
    ser = _mesh_ab(g, "serial", a, b, c0)
    db = _mesh_ab(g, "double_buffer", a, b, c0)
    assert ser._mesh["mode"] == "serial" and db._mesh["mode"] == "double_buffer"
    assert _same(ser, db)
    ref = 2.0 * (to_dense(a) @ to_dense(b)) + 0.5 * to_dense(c0)
    np.testing.assert_allclose(to_dense(db), ref, rtol=1e-12, atol=1e-12)
    ser_f = _mesh_ab(g, "serial", a, b, filter_eps=1e-3)
    db_f = _mesh_ab(g, "double_buffer", a, b, filter_eps=1e-3)
    assert _same(ser_f, db_f)
    rec = flight.records()[-1]
    assert rec["op"] == "mesh_multiply" and rec["cannon_mode"] == "double_buffer"


def test_tas_route_bitwise_identity():
    bs_tall, bs = [4] * 12, [4] * 5
    rng = np.random.default_rng(17)
    at = make_random_matrix("AT", bs_tall, bs, occupation=0.5, rng=rng, device="cpu")
    b = make_random_matrix("B", bs, bs, occupation=0.6, rng=rng, device="cpu")
    c0 = make_random_matrix("C0", bs_tall, bs, occupation=0.3, rng=rng, device="cpu")
    outs, outs_f = {}, {}
    for mode in ("serial", "double_buffer"):
        set_config(cannon_overlap=mode)
        clear_mesh_plans()
        outs[mode] = tas_grouped_multiply(2.0, at, b, 0.5, c0, _grid(8))
        outs_f[mode] = tas_grouped_multiply(1.0, at, b, 0.0, None, _grid(8), filter_eps=1e-3)
    assert _same(outs["serial"], outs["double_buffer"])
    assert _same(outs_f["serial"], outs_f["double_buffer"])
    rec = flight.records()[-1]
    assert rec["op"] == "tas_mesh_multiply" and rec["cannon_mode"] == "double_buffer"
    ref = 2.0 * (to_dense(at) @ to_dense(b)) + 0.5 * to_dense(c0)
    np.testing.assert_allclose(to_dense(outs["double_buffer"]), ref, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------ measured plumbing
@pytest.mark.parametrize("n,grid_label", [(4, "1x2x2"), (6, "1x2x3")])
def test_measured_overlap_plumbing(n, grid_label, monkeypatch):
    monkeypatch.setenv("DBCSR_TPU_TORCH_SYNC_TIMING", "1")
    g = _grid(n)
    a, b = _rand("A"), _rand("B", seed=4)
    db = _mesh_ab(g, "double_buffer", a, b)
    ser = _mesh_ab(g, "serial", a, b)
    assert _same(ser, db)  # the measured paths stay bitwise identical
    gauge = metrics.gauge(ovl.MEASURED_GAUGE)
    for mode in ("double_buffer", "serial"):
        v = gauge.value(engine="mesh", grid=grid_label, mode=mode)
        assert 0.0 <= v <= 1.0, (mode, v)
    roll = stats.cannon_overlap_rollup()["mesh"][grid_label]
    assert roll["shift_exposed_s"] >= 0 and roll["compute_s"] > 0
    assert 0.0 <= roll["measured_exposed"] <= 1.0 and roll["modeled_ratio"] > 0
    cell = metrics.snapshot()["roofline"]["mesh"]["cannon_overlap"][grid_label]
    assert "measured_exposed" in cell and "modeled_ratio" in cell


def test_measured_dense_and_tas_engines(monkeypatch):
    monkeypatch.setenv("DBCSR_TPU_TORCH_SYNC_TIMING", "1")
    rng = np.random.default_rng(1)
    set_config(cannon_overlap="double_buffer")
    cannon_multiply_dense(_grid(8), rng.standard_normal((8, 16)), rng.standard_normal((16, 12)))
    v = metrics.gauge(ovl.MEASURED_GAUGE).value(engine="dense", grid="2x2x2",
                                                mode="double_buffer")
    assert 0.0 <= v <= 1.0
    assert stats.cannon_overlap_rollup()["dense"]["2x2x2"]["compute_s"] > 0
    at = make_random_matrix("AT", [4] * 12, [4] * 5, occupation=0.5, rng=rng, device="cpu")
    b = make_random_matrix("B", [4] * 5, [4] * 5, occupation=0.6, rng=rng, device="cpu")
    tas_grouped_multiply(1.0, at, b, 0.0, None, _grid(8))
    roll = stats.cannon_overlap_rollup()["tas"]["2x2x2"]
    assert roll["compute_s"] > 0 and roll["modeled_ratio"] > 0


def test_modeled_gauges_labeled_by_engine():
    a, b = _rand("A"), _rand("B", seed=4)
    set_config(cannon_overlap="serial")
    sparse_multiply_distributed(1.0, a, b, 0.0, None, _grid(4))
    rng = np.random.default_rng(1)
    cannon_multiply_dense(_grid(8), rng.standard_normal((8, 16)), rng.standard_normal((16, 12)))
    g = metrics.gauge("dbcsr_tpu_cannon_overlap_ratio")
    assert g.value(engine="mesh", grid="1x2x2") > 0
    assert g.value(engine="dense", grid="2x2x2") > 0
    assert metrics.gauge("dbcsr_tpu_cannon_tick_comm_bytes").value(engine="mesh",
                                                                    grid="1x2x2") > 0


def test_decision_on_event_bus():
    events.set_enabled(True)
    a, b = _rand("A"), _rand("B", seed=4)
    _mesh_ab(_grid(4), "double_buffer", a, b)
    evs = events.records(kind="cannon_overlap")
    assert evs and evs[-1]["mode"] == "double_buffer"
    assert evs[-1]["product_id"]  # correlated to the grid multiply


# ------------------------------------------------------------ resilience
_ROUTES = {
    # route: (images, fault site, breaker pseudo-driver, nan seed)
    "mesh": (4, "mesh_shift", ovl.DRIVER, 97),
    "gather": (6, "gather_chunk", ovl.GATHER_DRIVER, 5),
}


@pytest.mark.parametrize("route", sorted(_ROUTES))
@pytest.mark.parametrize("kind", ["raise", "nan", "oom"])
def test_tick_fault_degrades_to_serial_bit_for_bit(route, kind):
    n, site, driver, seed = _ROUTES[route]
    g = _grid(n)
    a, b = _rand("A"), _rand("B", seed=4)
    clean = _mesh_ab(g, "double_buffer", a, b, alpha=1.0)
    clear_mesh_plans()
    schedule = f"{site}:{kind},seed={seed},times=1" if kind == "nan" else f"{site}:{kind},times=1"
    with faults.inject_faults(schedule) as installed:
        set_config(cannon_overlap="double_buffer")
        out = sparse_multiply_distributed(1.0, a, b, 0.0, None, g)
    assert sum(s.fired for s in installed) == 1
    assert _same(out, clean)
    assert out._mesh["mode"] == "serial"
    assert flight.records()[-1]["cannon_mode"] == "serial"  # degraded
    assert any(k.startswith(f"{driver}|") for k in breaker.get_board().snapshot())
    assert _ctr("dbcsr_tpu_faults_injected_total") == 1
    assert _ctr("dbcsr_tpu_driver_fallback_total") == 1


@pytest.mark.parametrize("kind", ["raise", "nan"])
def test_tas_tick_fault_degrades_to_serial_bit_for_bit(kind):
    rng = np.random.default_rng(7)
    at = make_random_matrix("AT", [4] * 12, [4] * 5, occupation=0.5, rng=rng, device="cpu")
    b = make_random_matrix("B", [4] * 5, [4] * 5, occupation=0.6, rng=rng, device="cpu")
    set_config(cannon_overlap="double_buffer")
    clean = tas_grouped_multiply(1.0, at, b, 0.0, None, _grid(8))
    clear_mesh_plans()
    schedule = "tas_tick:nan,seed=11,times=1" if kind == "nan" else "tas_tick:raise,times=1"
    with faults.inject_faults(schedule) as installed:
        out = tas_grouped_multiply(1.0, at, b, 0.0, None, _grid(8))
    assert sum(s.fired for s in installed) == 1
    assert _same(out, clean)
    assert flight.records()[-1]["cannon_mode"] == "serial"
    assert any(k.startswith("cannon_db|") and "tas" in k
               for k in breaker.get_board().snapshot())


def test_collective_fault_raises_before_any_move_and_retry_is_clean():
    g = _grid(4)
    a, b, c0 = _rand("A"), _rand("B", seed=4), _rand("C", occ=0.3, seed=5)
    clean = _mesh_ab(g, "double_buffer", a, b, c0)
    before = [x.data.clone() for x in c0.bins]
    with faults.inject_faults("collective:raise,times=1") as installed:
        with pytest.raises(RuntimeError):
            sparse_multiply_distributed(2.0, a, b, 0.5, c0, g)
        again = sparse_multiply_distributed(2.0, a, b, 0.5, c0, g)
    assert sum(s.fired for s in installed) == 1
    assert _ctr("dbcsr_tpu_faults_injected_total", site="collective") == 1
    assert all(torch.equal(x.data, y) for x, y in zip(c0.bins, before))
    assert _same(again, clean)


def test_shift_flip_is_caught_by_the_abft_probe_and_recovered():
    """A finite flip in a shifted panel, which no output check sees,
    breaks the shift probe under ABFT: the multiply re-runs in serial
    order, bit for bit the clean product."""
    g = _grid(4)
    a, b = _rand("A"), _rand("B", seed=4)
    set_config(abft="verify")
    clean = _mesh_ab(g, "double_buffer", a, b, alpha=1.0)
    clear_mesh_plans()
    with faults.inject_faults("mesh_shift:flip,seed=3,times=1") as installed:
        out = sparse_multiply_distributed(1.0, a, b, 0.0, None, g)
    assert sum(s.fired for s in installed) == 1
    assert _same(out, clean)
    assert _ctr("dbcsr_tpu_abft_mismatches_total", driver=ovl.DRIVER) == 1
    assert _ctr("dbcsr_tpu_abft_recoveries_total", driver=ovl.DRIVER) == 1


def test_open_breaker_routes_serial_preemptively():
    board = breaker.get_board()
    board.record_failure(ovl.DRIVER, ("mesh", "1x2x2"), kind="validation")
    assert board.state(ovl.DRIVER, ("mesh", "1x2x2")) == breaker.OPEN
    set_config(cannon_overlap="double_buffer")
    assert ovl.resolve_mode("mesh", "1x2x2", 2) == ("serial", "breaker-open")
    a, b = _rand("A"), _rand("B", seed=4)
    out = sparse_multiply_distributed(1.0, a, b, 0.0, None, _grid(4))
    assert flight.records()[-1]["cannon_mode"] == "serial"
    assert _same(out, _mesh_ab(_grid(4), "serial", a, b, alpha=1.0))


def test_degraded_or_open_pipeline_publishes_no_measurement(monkeypatch):
    monkeypatch.setenv("DBCSR_TPU_TORCH_SYNC_TIMING", "1")
    a, b = _rand("A"), _rand("B", seed=4)
    with faults.inject_faults("mesh_shift:nan,seed=97,times=1"):
        _mesh_ab(_grid(4), "double_buffer", a, b, alpha=1.0)
    roll = stats.cannon_overlap_rollup().get("mesh", {}).get("1x2x2", {})
    assert "measured_exposed" not in roll, roll
    stats.reset()
    breaker.reset_board()
    breaker.get_board().record_failure(ovl.DRIVER, ("mesh", "1x2x2"), kind="validation")
    _mesh_ab(_grid(4), "double_buffer", a, b, alpha=1.0)
    roll = stats.cannon_overlap_rollup().get("mesh", {}).get("1x2x2", {})
    assert "measured_exposed" not in roll, roll


# ---------------------------------------------- models and probes vs JAX
@pytest.mark.parametrize("kind", ["cpu", "TPU v5 lite"])
def test_tick_models_match_jax(kind):
    """Both packages' peak rows for ``kind``: the same balance (the H100
    row is the port's own, `test_tick_model_reads_the_h100_row`)."""
    args = (96, 80, 192, 2, 2, 8, "float64")
    assert costmodel.cannon_tick_model(*args, kind=kind) == \
        jax_costmodel.cannon_tick_model(*args, kind=kind)
    margs = (40, 36, 23, 23, 23, 832484, 2, 4, 8, "float64")
    for name in ("mesh_tick_model", "gather_chunk_model"):
        assert getattr(costmodel, name)(*margs, kind=kind) == \
            getattr(jax_costmodel, name)(*margs, kind=kind)


def test_shift_probes_match_jax():
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((5, 3, 4)), rng.standard_normal((2, 4, 4))]
    got = abft.tree_probe([torch.from_numpy(x) for x in xs])
    want = jax_abft.tree_probe(tuple(xs))
    assert abs(got - want) <= 1e-12 * abs(want)
    for before, after, n in ((100.0, 100.0 + 1e-13, 56), (100.0, 101.0, 56),
                             (1.0, float("nan"), 8)):
        assert abft.shift_conserved(before, after, torch.float64, n) == \
            jax_abft.shift_conserved(before, after, np.float64, n)


def test_tick_model_reads_the_h100_row():
    h100 = costmodel.peaks_for("NVIDIA H100 80GB HBM3")
    tick = costmodel.mesh_tick_model(40, 36, 23, 23, 23, 832484, 2, 4, 8, "float64",
                                     kind="NVIDIA H100 80GB HBM3")
    assert tick["t_comm_s"] == (40 + 36) * 23 * 23 * 8 / (h100["ici_gbs"] * 1e9)
    assert tick["t_compute_s"] == tick["tick_flops"] / (
        costmodel.peak_gflops("NVIDIA H100 80GB HBM3", "float64") * 1e9)
