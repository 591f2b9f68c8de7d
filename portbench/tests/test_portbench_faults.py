"""The check sees a broken timed path: each fault a cell can have,
planted under the harness, turns ``correct`` false."""

import json
import time

import pytest

import dbcsr_tpu_torch as dt
from dbcsr_tpu_torch import tensor as dtt
from portbench import harness
from portbench.tests import tiny


def _unchanged_multiply(transa, transb, alpha, a, b, beta, c, **kw):
    return 0  # C keeps what it held: the step returns its state unchanged


def _half_multiply(transa, transb, alpha, a, b, beta, c, **kw):
    return REAL["multiply"](transa, transb, alpha, a, b, beta, c,
                            last_row=a.nblkrows // 2 - 1, **kw)


def _altered_multiply(*args, **kw):
    out = REAL["multiply"](*args, **kw)
    c = args[6]
    c.bins[0].data.view(-1)[0] += 1e-6
    return out


def _unchanged_contract(alpha, t, m, beta, c, **kw):
    return 0


def _half_contract(alpha, t, m, beta, c, **kw):
    n = len(t.blk_sizes[0])
    return REAL["contract"](alpha, t, m, beta, c, bounds_2=[(0, n // 2 - 1), None], **kw)


def _altered_contract(alpha, t, m, beta, c, **kw):
    out = REAL["contract"](alpha, t, m, beta, c, **kw)
    c.matrix.bins[0].data.view(-1)[0] += 1e-6
    return out


REAL = {"multiply": dt.multiply, "contract": dtt.contract}
FAULTS = {
    "scf_multiply": (dt, "multiply", {"unchanged": _unchanged_multiply,
                                      "half": _half_multiply, "altered": _altered_multiply}),
    "scf_contract": (dtt, "contract", {"unchanged": _unchanged_contract,
                                       "half": _half_contract, "altered": _altered_contract}),
}


def _reads_incorrect(out) -> None:
    assert out["correct"] is False
    assert out["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


@pytest.mark.parametrize("cell", ["tiny_ns.scf", "tiny_ri.scf"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_reads_incorrect(tmp_path, on_cpu, monkeypatch, cell, fault):
    module, name, faults = FAULTS[tiny.CELLS[cell]["kind"]]
    pb, bench = tiny.add_cells(tmp_path)
    monkeypatch.setattr(module, name, faults[fault])
    _reads_incorrect(harness.run_cell(cell, 12345, 0.2, False, "cpu", bench, 0.0, pb_dir=pb))


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", [
    ("ns_f64.scf", "unchanged"), ("ns_f64.scf", "half"), ("ns_f64.scf", "altered"),
    (tiny.TWIN["scf_contract"], "half"), (tiny.TWIN["scf_contract"], "altered")])
def test_fault_reads_incorrect_at_the_cells_own_size(card, monkeypatch, cell, fault):
    """The same faults through a whole run of the committed cell, at its
    own size on the card."""
    wl, _, _ = harness.load_cell(cell)
    module, name, faults = FAULTS[wl["kind"]]
    monkeypatch.setattr(module, name, faults[fault])
    out = harness.run_cell(cell, 2**31 + 31, 1.0, False, card, tiny.BENCH, time.perf_counter())
    print(json.dumps(out["checks"]))
    _reads_incorrect(out)


def test_reservoir_keeps_a_sample_and_the_last():
    from portbench.traffic.scf_multiply import Reservoir

    r = Reservoir(3, 7)
    for i in range(1000):
        r.offer(i)
    kept = r.kept()
    assert len(kept) == 4 and kept[-1] == 999 and len(set(kept)) == 4
    again = Reservoir(3, 7)
    for i in range(1000):
        again.offer(i)
    assert again.kept() == kept
