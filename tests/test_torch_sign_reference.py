"""The port's sign iteration held against the benchmark's plain reference
(`portbench/reference/sign.py`) on the CPU.

The reference works the Newton–Schulz loop out on the dense matrix with
DBCSR's filter at block granularity; the port runs
`dbcsr_tpu_torch.models.sign_iteration` on the block-sparse matrix.
Cases: the sign cell's own gapped input (`portbench/traffic/sign_loop.py`)
at 8 molecules of 23 functions; an input whose couplings decay with the
distance between molecules, at an eps that drops products and blocks,
where the port's ``filter`` counter must equal the reference's counts;
and the reference in float32, which the cell's float64 limits must
fail.

Tolerances: values 1e-12 of the largest reference value (float64 sums
in another order; the converged iterate is a fixed point, so the gap
stays at a few units of rounding); the trace within 1e-10 of its
invariant relative (each diagonal value off by its rounding; 1e-8
absolute where dropped blocks move the iterate by about their size);
step counts and patterns exact.
"""

import os

import numpy as np
import pytest
import torch

import dbcsr_tpu_torch as dt
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.models import sign_iteration
from portbench import harness
from portbench.answers import output_groups
from portbench.reference import sign as ref

CFG = dict(harness.load_json(os.path.join(harness.PB_DIR, "configs", "h2o96_sign_f64.json")),
           molecules=8)
SIGN_LOOP = harness.load_module(os.path.join(harness.PB_DIR, "traffic", "sign_loop.py"),
                                "portbench_traffic_sign_loop")


@pytest.fixture(autouse=True)
def fresh():
    mm.clear_plan_cache()
    mm.reset_totals()
    yield
    mm.clear_plan_cache()


def _matrix(keys, n, bs, blocks):
    m = dt.create("A", [bs] * n, [bs] * n, torch.float64, device="cpu")
    m.stage_device_blocks(keys // n, keys % n, blocks)
    m.finalize()
    return m


def _port(m, n, bs, **loop):
    x, history = sign_iteration(m, **loop)
    return x, history, ref.dense_answer(output_groups(x), x.keys, np.full(n, bs), "cpu")


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_port_matches_the_reference_on_the_cells_input(seed):
    inp = SIGN_LOOP.Inputs(CFG, seed, "cpu")
    n, bs = inp.n, inp.block
    x, history, got = _port(_matrix(inp.keys, n, bs, inp.values(0)), n, bs, **inp.loop)
    want = inp.reference(0)
    r = ref.judge(got, x.keys, len(history), want, inp.trace)
    assert inp.trace == (18 - 5) * 8
    assert r["steps_mismatch"] == 0 and want.steps < inp.loop["steps"]
    assert history[-1] < inp.loop["tol"] and want.history[-1] < inp.loop["tol"]
    assert r["pattern_mismatch"] == 0
    assert r["rel_err"] <= 1e-12
    assert r["trace_err"] <= 1e-10 * inp.trace
    # nothing drops at the cell's eps: every candidate product is kept
    assert want.products["dropped"] == 0 and want.products["candidates"] > 0


def _decaying(seed=3, n=8, bs=23, occ=5, decay=0.1):
    """A gapped symmetric input whose couplings between molecules i and j
    scale by decay**|i - j|, every block stored."""
    rng = np.random.default_rng(seed)
    size = n * bs
    w = rng.standard_normal((size, size)) * 0.1 / np.sqrt(size)
    mol = np.arange(size) // bs
    a = (np.triu(w) + np.triu(w, 1).T) * decay ** np.abs(mol[:, None] - mol[None, :])
    a += np.diag(np.tile([-1.0] * occ + [1.0] * (bs - occ), n))
    return torch.from_numpy(a)


def test_filter_counts_and_patterns_match_the_reference_where_products_drop():
    n, bs, eps, steps = 8, 23, 1e-6, 12
    a = _decaying()
    keys = np.arange(n * n, dtype=np.int64)
    blocks = ref.blocks_of(a, bs).reshape(n * n, bs, bs).contiguous()
    x, history, got = _port(_matrix(keys, n, bs, blocks), n, bs, steps=steps,
                            filter_eps=eps, tol=0.0)
    counted = mm.read_totals()["filter"]
    want = ref.iterate(a, torch.ones(n, n, dtype=torch.bool), bs, steps, eps, 0.0)
    assert want.products["dropped"] > 0 and want.blocks["dropped"] > 0
    assert counted == {"candidates": want.products["candidates"],
                       "dropped": want.products["dropped"],
                       "blocks_kept": want.blocks["kept"],
                       "blocks_dropped": want.blocks["dropped"]}
    r = ref.judge(got, x.keys, len(history), want, (18 - 5) * 8)
    assert r["pattern_mismatch"] == 0 and len(x.keys) < n * n
    assert r["steps_mismatch"] == 0 and r["rel_err"] <= 1e-12
    assert r["trace_err"] <= 1e-8


def test_the_reference_in_float32_fails_the_cells_limits():
    inp = SIGN_LOOP.Inputs(CFG, 5, "cpu")
    want = inp.reference(0)
    low = inp.reference(0, dtype=torch.float32)
    r = ref.judge(low.x, ref.pattern_keys(low.pattern), low.steps, want, inp.trace)
    limits = harness.load_json(os.path.join(harness.PB_DIR, "workloads",
                                            "h2o96.sign.json"))["params"]["limits"]
    assert r["rel_err"] > 100 * limits["rel_err"]
    assert r["trace_err"] > limits["trace_err"]
    # float32's rounding floor keeps ||X' - X|| above tol: it never converges
    assert not low.history[-1] < inp.loop["tol"] and low.steps == inp.loop["steps"]
