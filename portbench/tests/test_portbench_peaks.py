"""The frozen count of the kernels' roofline."""

import numpy as np
import pytest

from portbench import harness, inputs, peaks


def test_peaks_are_the_data_sheets():
    assert peaks.PEAK_FLOPS["float64"] == 67e12 and peaks.PEAK_BYTES_PER_S == 3.35e12


def test_count_by_hand():
    # A: 2x2 blocks of sizes rows (2, 3) x k (4, 1); B: k (4, 1) x cols (5, 6)
    rs, ks, cs = np.array([2, 3]), np.array([4, 1]), np.array([5, 6])
    a = np.array([0 * 2 + 0, 1 * 2 + 1])          # A[0,0], A[1,1]
    b = np.array([0 * 2 + 1, 1 * 2 + 0, 1 * 2 + 1])  # B[0,1], B[1,0], B[1,1]
    c0 = np.array([0 * 2 + 0])                    # C0[0,0]
    got = peaks.product_count(a, b, c0, rs, ks, cs, beta=1.0)
    # products: A00*B01 -> C01; A11*B10 -> C10; A11*B11 -> C11
    assert got["products"] == 3
    assert got["flops"] == 2 * (2 * 4 * 6 + 3 * 1 * 5 + 3 * 1 * 6)
    assert list(got["c_keys"]) == [0, 1, 2, 3]
    a_read = 2 * 4 + 3 * 1
    b_read = 4 * 6 + 1 * 5 + 1 * 6
    c_read = 2 * 5
    c_write = 2 * 5 + 2 * 6 + 3 * 5 + 3 * 6
    assert got["bytes"] == 8 * (a_read + b_read + c_read + c_write)
    # beta 0 reads nothing of C0, but its blocks stay in the result
    got0 = peaks.product_count(a, b, c0, rs, ks, cs, beta=0.0)
    assert got0["bytes"] == 8 * (a_read + b_read + c_write)
    # an A block no B block meets is not read
    got1 = peaks.product_count(np.array([0, 1]), np.array([1]), np.empty(0, np.int64),
                               rs, ks, cs, beta=0.0)
    assert got1["products"] == 1 and got1["bytes"] == 8 * (2 * 4 + 4 * 6 + 2 * 6)


def test_north_star_flops():
    """The north star's true flops are 2.022e10 on the .perf driver's
    pattern (832,484 products); this benchmark draws its own at the same
    occupancy, exactly 10% of the blocks, and its count of products
    differs by the draw (823,651: 1.1% fewer)."""
    _, cfg, kind = harness.load_cell("ns_f64.scf")
    inp = kind.Inputs(cfg, 1, "cpu")
    got = peaks.product_count(inp.keys["A"], inp.keys["B"], inp.keys["C"], inp.sizes,
                              inp.sizes, inp.sizes, inp.beta)
    assert abs(got["flops"] - 2.022e10) / 2.022e10 < 0.02
    assert len(got["c_keys"]) == pytest.approx(187173, rel=0.01)
    # least bytes: A, B and C0 read once (beta 1), C written once
    n = lambda keys: int((inp.sizes[keys // len(inp.sizes)]
                          * inp.sizes[keys % len(inp.sizes)]).sum())
    assert got["bytes"] == 8 * (n(inp.keys["A"]) + n(inp.keys["B"]) + n(inp.keys["C"])
                                + n(got["c_keys"]))


@pytest.mark.parametrize("busy_over_least", [1.0, 1.5, 40.0])
def test_share_never_over_100(busy_over_least):
    least = peaks.least_time_s(2.022e10, 1.03e9)
    share = peaks.roofline_pct(least, least * busy_over_least)
    assert 0 < share <= 100.0
    assert peaks.roofline_pct(least, 0.0) is None


def test_random_patterns_exact_counts():
    keys = inputs.random_pattern(435, 435, 0.1, 9)
    assert len(keys) == round(0.1 * 435 * 435) and len(np.unique(keys)) == len(keys)
    d = inputs.symmetric_pattern(96, 0.2, 9)
    r, c = d // 96, d % 96
    assert set(zip(r.tolist(), c.tolist())) == set(zip(c.tolist(), r.tolist()))
    assert np.all(np.isin(np.arange(96) * 97, d))
