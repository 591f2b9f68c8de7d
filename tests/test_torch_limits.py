"""Block and element limits with the windowed beta in the port, held
against the JAX package on the CPU.

The same numpy-seeded operands (JAX matrices carried across with
`dbcsr_tpu_torch.interop`) go through both packages' `multiply` with
block limits, element limits on and off the block boundaries, beta
inside and outside (0, 1) and ``retain_sparsity``, after
`tests/test_multiply_limits_elements.py`; through both `crop_matrix`;
and through both `run_perf` with a `.perf` limits line.  f64 only.

Tolerances: C's pattern equal; C relative to max |C| within 1e-12 of the
JAX package's and within 1e-11 of the windowed-dgemm oracle (ref
`dbcsr_test_multiply.F:631-633`); C outside the window bit for bit as it
was; crops exact; checksums within 1e-12 relative.
"""

import numpy as np
import pytest

from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.mm.multiply import multiply as jax_multiply
from dbcsr_tpu.ops import operations as jops
from dbcsr_tpu.ops import test_methods as jax_tm
from dbcsr_tpu.perf import driver as jax_driver

from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.ops import operations as pops
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.perf.driver import PerfConfig, expand_block_sizes, run_perf


@pytest.fixture(autouse=True)
def jax_stack_config():
    cfg = jax_get_config()
    prev = {"mm_driver": cfg.mm_driver, "mm_format": cfg.mm_format,
            "incremental": cfg.incremental}
    jax_set_config(mm_format="stack", incremental="off", mm_driver="xla")
    yield
    jax_set_config(**prev)


def jax_state(m) -> dict:
    return {
        "row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
        "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype),
        "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
        "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in m.bins],
    }


def draw(sizes, occs, seed, pattern=((1, 1), (1, 2))):
    """(JAX, port) A, B, C: m x k, k x n and m x n elements, blocked by
    the .perf pattern (sizes 1 and 2 in turn by default)."""
    m_el, n_el, k_el = sizes
    rbs, cbs, kbs = (expand_block_sizes(x, list(pattern)) for x in (m_el, n_el, k_el))
    out = []
    for i, (name, rows, cols) in enumerate((("A", rbs, kbs), ("B", kbs, cbs), ("C", rbs, cbs))):
        jm = jax_tm.make_random_matrix(name, rows, cols, occupation=occs[i],
                                       rng=np.random.default_rng(seed + i))
        out.append((jm, matrix_from_numpy_state(jax_state(jm), "cpu", name=name)))
    return out


def rel(got, want) -> float:
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1.0)


def run_both(ops, alpha, beta, retain=False, **kw):
    (ja, pa), (jb, pb), (jc, pc) = ops
    before = port_tm.to_dense(pc)
    jflops = jax_multiply("N", "N", alpha, ja, jb, beta, jc, retain_sparsity=retain, **kw)
    pflops = mm.multiply("N", "N", alpha, pa, pb, beta, pc, retain_sparsity=retain, **kw)
    assert pflops == jflops
    assert np.array_equal(pc.keys, jc.keys)
    assert pc._mm_algorithm == "stack"
    got = port_tm.to_dense(pc)
    assert rel(got, jax_tm.to_dense(jc)) <= 1e-12
    return before, got


ELEMENT_CASES = [
    # 1-based inclusive (first_row, last_row, first_col, last_col, first_k, last_k)
    ((20, 20, 20), (2, 6, 3, 7, 6, 7), 0.0, True),       # multiply_ALPHA
    ((20, 20, 20), (2, 6, 3, 7, 6, 7), 3.0, True),       # multiply_BETA
    ((50, 50, 50), (1, 50, 9, 18, 1, 50), 0.0, False),   # LIMITS_COL_2
    ((50, 50, 50), (1, 50, 1, 50, 9, 18), 0.5, False),   # LIMITS_K_2
    ((50, 50, 50), (9, 18, 11, 20, 1, 50), -1.5, False),  # LIMITS_MIX_1
    ((50, 50, 50), (11, 20, 11, 20, 13, 18), 0.7, True),  # LIMITS_MIX_5
    ((25, 50, 75), (1, 25, 9, 18, 1, 75), 2.0, True),    # LIMITS_COL_4
    ((30, 30, 30), (4, 27, 1, 30, 1, 30), 1.0, False),   # beta 1: nothing scales
]


@pytest.mark.parametrize("sizes,limits,beta,retain", ELEMENT_CASES)
def test_element_limits_match_jax(sizes, limits, beta, retain):
    ops = draw(sizes, (0.5, 0.5, 0.5) if retain else (0.9, 0.9, 0.6), seed=100)
    (ja, pa), (jb, pb), (_, pc) = ops
    da, db = port_tm.to_dense(pa), port_tm.to_dense(pb)
    stored = port_tm.to_dense(pops.set_value(pc.copy(), 1.0)) != 0  # C's blocks, elementwise
    fr, lr, fc, lc, fk, lk = (x - 1 for x in limits)
    before, got = run_both(ops, 1.25, beta, retain, element_limits=(fr, lr, fc, lc, fk, lk))
    want = before.copy()
    want[fr:lr + 1, fc:lc + 1] = (1.25 * da[fr:lr + 1, fk:lk + 1] @ db[fk:lk + 1, fc:lc + 1]
                                  + beta * before[fr:lr + 1, fc:lc + 1])
    if retain:
        want[~stored] = 0  # ref dbcsr_impose_sparsity
    assert rel(got, want) <= 1e-11
    outside = np.ones(got.shape, bool)
    outside[fr:lr + 1, fc:lc + 1] = False
    assert np.array_equal(got[outside], before[outside])


BLOCK_CASES = [
    dict(first_row=1, last_row=4),
    dict(first_col=2, last_col=9, first_k=3),
    dict(last_row=7, first_col=0, last_col=5, first_k=2, last_k=8),
    dict(first_k=4, last_k=10),  # k only: no window, beta everywhere
    dict(first_row=3, last_row=3, first_col=3, last_col=3, first_k=3, last_k=3),
]


@pytest.mark.parametrize("limits", BLOCK_CASES)
@pytest.mark.parametrize("beta", [0.0, 0.6])
def test_block_limits_match_jax(limits, beta):
    ops = draw((24, 26, 22), (0.8, 0.8, 0.7), seed=7, pattern=((1, 2), (1, 3)))
    (_, pc0) = ops[2]
    before, got = run_both(ops, 0.9, beta, **limits)
    roff, coff = pc0.row_blk_offsets, pc0.col_blk_offsets
    r0 = roff[limits.get("first_row", 0)]
    r1 = roff[limits["last_row"] + 1] if "last_row" in limits else got.shape[0]
    c0 = coff[limits.get("first_col", 0)]
    c1 = coff[limits["last_col"] + 1] if "last_col" in limits else got.shape[1]
    outside = np.ones(got.shape, bool)
    outside[r0:r1, c0:c1] = False
    assert np.array_equal(got[outside], before[outside])


def test_windowed_beta_with_block_limits():
    """Block limits follow the windowed beta: C blocks outside keep their
    exact old values (the JAX package's test, on the port)."""
    (ja, pa), (jb, pb), (jc, pc) = draw((7, 7, 7), (1.0, 1.0, 1.0), seed=9,
                                        pattern=((1, 2), (1, 3), (1, 2)))
    dc, da, db = port_tm.to_dense(pc), port_tm.to_dense(pa), port_tm.to_dense(pb)
    mm.multiply("N", "N", 1.0, pa, pb, 2.0, pc, first_row=1, last_row=1)
    want = dc.copy()
    want[2:5, :] = da[2:5, :] @ db + 2.0 * dc[2:5, :]
    np.testing.assert_allclose(port_tm.to_dense(pc), want, rtol=1e-12, atol=1e-12)


def test_limits_keep_the_stack_format_and_key_the_plan():
    """A limited product never leaves the stack format, even full; the
    limits are part of the plan-cache key."""
    (_, pa), (_, pb), (_, pc) = draw((20, 20, 20), (1.0, 1.0, 1.0), seed=11)
    mm.clear_plan_cache()
    mm.reset_totals()
    outcomes = []
    for kw in (dict(first_row=1), dict(first_row=1), dict(first_row=2),
               dict(element_limits=(0, 10, None, None, 3, 12))):
        c = pc.copy()
        mm.multiply("N", "N", 1.0, pa, pb, 0.5, c, **kw)
        outcomes.append(c._mm_plan_cache)
    assert outcomes == ["miss", "hit", "miss", "miss"]
    assert mm.read_totals()["formats"] == {"stack:structural": 4}
    c = pc.copy()
    mm.multiply("N", "N", 1.0, pa, pb, 0.5, c)
    assert c._mm_algorithm == "dense"  # the same product, unlimited


def test_limit_argument_errors():
    (_, pa), (_, pb), (_, pc) = draw((10, 10, 10), (1.0, 1.0, 1.0), seed=12)
    with pytest.raises(ValueError, match="not both"):
        mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc, first_row=0,
                    element_limits=(0, 1, None, None, None, None))
    with pytest.raises(ValueError, match="out of range"):
        mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc, element_limits=(0, 10, 0, 9, 0, 9))
    with pytest.raises(ValueError, match="6-tuple"):
        mm.multiply("N", "N", 1.0, pa, pb, 0.0, pc, element_limits=(0, 1))


@pytest.mark.parametrize("kind", ["N", "S"])
@pytest.mark.parametrize("bounds", [((3, 17), (5, 11)), (None, (0, 6)), ((8, 8), None)])
def test_crop_matrix_matches_jax(kind, bounds):
    sizes = expand_block_sizes(20, [(1, 2), (1, 3)])
    jm = jax_tm.make_random_matrix("M", sizes, sizes, occupation=0.6, matrix_type=kind,
                                   rng=np.random.default_rng(13))
    pm = matrix_from_numpy_state(jax_state(jm), "cpu")
    jc = jops.crop_matrix(jm, row_bounds=bounds[0], col_bounds=bounds[1])
    pc = pops.crop_matrix(pm, row_bounds=bounds[0], col_bounds=bounds[1])
    assert pc.matrix_type == "N" and pm.matrix_type == kind
    assert np.array_equal(pc.keys, jc.keys)
    assert np.array_equal(port_tm.to_dense(pc), jax_tm.to_dense(jc))
    assert np.array_equal(port_tm.to_dense(pm), jax_tm.to_dense(jm))  # input untouched


@pytest.mark.parametrize("limits", [(3, 40, 0, 0, 7, 52), (0, 0, 11, 29, 0, 0),
                                    (5, 5, 1, 60, 20, 21)])
def test_run_perf_limits_match_jax(limits):
    kw = dict(m=45, n=60, k=55, sparsity_a=0.3, sparsity_b=0.3, sparsity_c=0.5, beta=0.5,
              alpha=1.5, limits=limits, nrep=2, m_sizes=[(1, 4), (1, 6)],
              n_sizes=[(1, 5)], k_sizes=[(2, 3), (1, 7)])
    port = run_perf(PerfConfig(**kw), verbose=False, device="cpu")
    jax = jax_driver.run_perf(jax_driver.PerfConfig(**kw), verbose=False, n_devices=1)
    assert port["plan_cache"] == ["miss", "hit"]
    assert port["algorithms"] == ["stack", "stack"] and port["algorithm"] == jax["algorithm"]
    for key in ("checksum_c_in", "checksum", "checksum_pos"):
        assert abs(port[key] - jax[key]) <= 1e-12 * abs(jax[key]), key
