"""The control: the plain reference computed one precision lower in the
program's place must read as not correct under each cell's limits."""

import pytest

from portbench import control
from portbench.tests import tiny


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("seed", [1, 2**31 + 11, 2**40 + 3])
def test_control_fails_on_a_tiny_cell(tmp_path, on_cpu, cell, seed):
    pb, _ = tiny.add_cells(tmp_path)
    got = control.readings(cell, seed, "cpu", pb_dir=pb)
    assert any(v > lim for v, lim in got.values()), got
    assert got["rel_err"][0] > 1e-9


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(tiny.TWIN.values()))
def test_control_fails_at_the_cells_own_size(card, cell):
    got = control.readings(cell, 2**31 + 21, card)
    assert any(v > lim for v, lim in got.values()), got
