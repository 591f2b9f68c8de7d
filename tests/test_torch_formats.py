"""The dense and composite formats and the storage-format planner in the
port, held against the JAX package on the CPU.

* The planner's (format, reason) equals the JAX package's over an
  occupancy ladder, under each forced format, for the products only the
  stack format can run, and with a tuned row carrying format columns
  (after `tests/test_format.py:137-191`).
* Forced stack, dense and composite, and "auto", agree with each other
  and with the JAX package's run of the same format, on uniform,
  near-uniform (ceil) and mixed blockings, banded and full patterns,
  and on the chunked path (the canvas cap shrunk in both packages, as
  `tests/test_format.py:281` does); each executes the format the JAX
  package executes.
* Purification and the inverse square root agree with the JAX loops,
  and both packages took the same formats, multiply by multiply.
* The canvas cache serves a repeat and sees a bin changed in place.

Tolerances: C's pattern equal; C relative to max |C| within 1e-12 (f64)
of the JAX package's and of the port's stack run; the loops at 1e-10,
as `tests/test_torch_models.py`.
"""

import numpy as np
import pytest
import torch

from dbcsr_tpu.acc import params as jax_params
from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.core.matrix import create as jax_create
from dbcsr_tpu.mm import format_planner as jax_fp
from dbcsr_tpu.mm import multiply as jax_mm
from dbcsr_tpu.models import invsqrt as jax_invsqrt
from dbcsr_tpu.models import purify as jax_purify
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.ops import operations as jops
from dbcsr_tpu.ops import test_methods as jax_tm

from dbcsr_tpu_torch.acc import params
from dbcsr_tpu_torch.acc.smm import execute_stack, prepare_stack
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.mm import format_planner as fp
from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.models import invsqrt_iteration, make_test_density, mcweeny_purify
from dbcsr_tpu_torch.ops import operations as pops
from dbcsr_tpu_torch.ops import test_methods as port_tm

FIELDS = ("mm_format", "mm_dense", "mm_driver", "dense_occ_threshold",
          "composite_max_panels", "composite_ksup")


@pytest.fixture(autouse=True)
def clean_slate(tmp_path, monkeypatch):
    """Both packages' planners reset, their tuned tables in empty
    directories, and their configs restored."""
    monkeypatch.setenv("DBCSR_TPU_PARAMS_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("DBCSR_TPU_TORCH_PARAMS_DIR", str(tmp_path / "port"))
    jcfg0 = {f: getattr(jax_get_config(), f)
             for f in FIELDS + ("incremental", "dense_flop_ratio")}
    pcfg0 = {f: getattr(get_config(), f) for f in FIELDS}
    jax_set_config(mm_driver="xla", incremental="off")
    for reset in (jax_params.invalidate, params.invalidate, jax_fp.reset, fp.reset,
                  mm.reset_totals, mm.clear_plan_cache, jax_metrics.reset):
        reset()
    yield
    jax_set_config(**jcfg0)
    set_config(**pcfg0)
    for reset in (jax_params.invalidate, params.invalidate, jax_fp.reset, fp.reset):
        reset()


def both(**kw):
    """Set the same config fields in both packages."""
    jax_set_config(**kw)
    set_config(**kw)


def jax_state(m) -> dict:
    return {
        "row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
        "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype),
        "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
        "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in m.bins],
    }


def port_of(jm, name="M"):
    return matrix_from_numpy_state(jax_state(jm), "cpu", name=name)


def operand(name, sizes, pattern, rng, cols=None):
    """A JAX matrix holding standard-normal blocks at ``pattern``."""
    cols = sizes if cols is None else cols
    m = jax_create(name, sizes, cols)
    if pattern:
        r = np.array([i for i, _ in pattern])
        c = np.array([j for _, j in pattern])
        m.put_blocks(r, c, [rng.standard_normal((sizes[i], cols[j])) for i, j in pattern])
    return m.finalize()


def patterns(n, fill=None, band=None, rng=None):
    if band is not None:
        return [(i, j) for i in range(n) for j in range(n) if abs(i - j) <= band]
    return [(i, j) for i in range(n) for j in range(n) if rng.random() < fill] or [(0, 0)]


def draw(sizes, fill=None, band=None, seed=0, c_fill=0.3):
    """JAX and port A, B and C on one square blocking."""
    rng = np.random.default_rng(seed)
    n = len(sizes)
    jms = [operand("A", sizes, patterns(n, fill, band, rng), rng),
           operand("B", sizes, patterns(n, fill, band, rng), rng),
           operand("C", sizes, patterns(n, c_fill, None, rng), rng)]
    return jms, [port_of(m, m.name) for m in jms]


def choose_both(jms, pms, **kw):
    opts = dict(filter_eps=None, retain_sparsity=False, no_limits=True)
    opts.update(kw)
    jp = jax_fp.choose(*jms, **opts)
    pp = fp.choose(*pms, **opts)
    assert pp.occ == pytest.approx(jp.occ) if jp.occ is not None else pp.occ is None
    return (jp.fmt, jp.reason), (pp.fmt, pp.reason)


def rel(got, want) -> float:
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1.0)


# --------------------------------------------------------------- planner
LADDER = [dict(fill=f) for f in (0.15, 0.4, 0.7, 0.85, 1.0)] + [dict(band=1), dict(band=3)]


@pytest.mark.parametrize("fmt", ["auto", "stack", "dense", "composite"])
@pytest.mark.parametrize("shape", LADDER, ids=lambda d: "-".join(f"{k}{v}" for k, v in d.items()))
def test_planner_matches_jax_over_the_ladder(fmt, shape):
    both(mm_format=fmt)
    jms, pms = draw([4] * 8, seed=1, **shape)
    want, got = choose_both(jms, pms)
    assert got == want
    if fmt == "auto" and shape.get("fill") == 1.0:
        assert got == ("dense", "heuristic")


@pytest.mark.parametrize("sizes", [[4] * 7 + [3], [2, 5, 3, 4, 5, 2, 3]])
def test_planner_matches_jax_on_other_blockings(sizes):
    for fill in (0.3, 1.0):
        for fmt in ("auto", "composite"):
            both(mm_format=fmt)
            want, got = choose_both(*draw(sizes, fill=fill, seed=2))
            assert got == want


@pytest.mark.parametrize("case", ["filtered", "retain", "limits", "symmetric_c",
                                  "mm_dense_off", "pallas", "mm_dense_on"])
def test_planner_matches_jax_on_structural_products(case):
    jms, pms = draw([4] * 6, fill=1.0, seed=3)
    kw = {}
    if case == "filtered":
        kw = dict(filter_eps=1e-3)
    elif case == "retain":
        kw = dict(retain_sparsity=True)
    elif case == "limits":
        kw = dict(no_limits=False)
    elif case == "symmetric_c":
        jms[2] = jax_create("C", [4] * 6, [4] * 6, matrix_type="S").finalize()
        pms[2] = BlockSparseMatrix("C", [4] * 6, [4] * 6, matrix_type="S", device="cpu")
    elif case == "pallas":
        both(mm_driver="pallas")
    else:
        both(mm_dense=case == "mm_dense_on", dense_occ_threshold=2.0)
    want, got = choose_both(jms, pms, **kw)
    assert got == want
    assert got == (("dense", "heuristic") if case == "mm_dense_on" else ("stack", "structural"))


def test_planner_tuned_rows_match_jax():
    """Rows with format columns steer both planners above their occupancy
    crossover, the stack below it (the heuristic switched off)."""
    for row in ({"m": 4, "n": 4, "k": 4, "format": "dense", "format_occ": 0.5},
                {"m": 3, "n": 3, "k": 3, "format": "composite", "format_occ": 0.05}):
        row.update(dtype="float64", stack_size=0, format_gflops=9.9, tuned_by="test")
        jax_params.save_entry(dict(row))
        params.save_entry(dict(row))
    both(mm_format="auto", dense_occ_threshold=2.0)
    # off: the JAX package's emulated-dtype cost model has no port
    jax_set_config(dense_flop_ratio=0)
    seen = set()
    for size, shape in [(4, dict(fill=f)) for f in (0.3, 0.5, 0.7, 1.0)] + \
                       [(3, dict(band=1)), (3, dict(fill=1.0)), (3, dict(fill=0.02))]:
        want, got = choose_both(*draw([size] * 8, seed=4, **shape))
        assert got == want
        seen.add(got)
    assert {("dense", "tuned"), ("stack", "tuned"), ("composite", "tuned")} <= seen


def test_format_knob_validation():
    with pytest.raises(ValueError):
        set_config(mm_format="bogus")
    with pytest.raises(ValueError):
        set_config(composite_max_panels=1)
    with pytest.raises(ValueError):
        set_config(composite_ksup=0.0)
    set_config(mm_format="composite")
    assert get_config().mm_format == "composite"


# ------------------------------------------------------------- execution
BLOCKINGS = {"uniform": [4] * 8, "near_uniform": [5] * 6 + [3], "mixed": [2, 5, 3, 4, 5, 2, 3]}


def run_format(fmt, jms, pms, alpha=0.7, beta=0.5):
    """One product under ``fmt`` in both packages, on copies of C."""
    both(mm_format=fmt)
    jc, pc = jms[2].copy(), pms[2].copy()
    jflops = jax_mm.multiply("N", "N", alpha, jms[0], jms[1], beta, jc)
    pflops = mm.multiply("N", "N", alpha, pms[0], pms[1], beta, pc)
    assert pflops == jflops
    assert pc._mm_algorithm == jc._mm_algorithm
    assert np.array_equal(pc.keys, jc.keys)
    got = port_tm.to_dense(pc)
    assert rel(got, jax_tm.to_dense(jc)) <= 1e-12
    return pc, got


@pytest.mark.parametrize("blocking", list(BLOCKINGS))
@pytest.mark.parametrize("shape", [dict(band=1), dict(fill=1.0)], ids=["band", "full"])
def test_formats_agree_with_stack_and_jax(blocking, shape):
    jms, pms = draw(BLOCKINGS[blocking], seed=5, **shape)
    stack_c, ref = run_format("stack", jms, pms)
    executed = {}
    for fmt in ("dense", "composite", "auto"):
        pc, got = run_format(fmt, jms, pms)
        executed[fmt] = pc._mm_algorithm
        assert rel(got, ref) <= 1e-12
        if pc._mm_algorithm != "stack":
            assert pc.nblks == pc.nblkrows * pc.nblkcols  # the full pattern
            assert pc._mm_plan_cache is None and pc._mm_spans == []
            assert set(pc._mm_phase_s) == {"format", pc._mm_algorithm}
    assert executed["dense"] == "dense"
    uniform_band = blocking == "uniform" and "band" in shape
    assert executed["composite"] == ("composite" if uniform_band else "stack")
    assert executed["auto"] == ("dense" if "fill" in shape else "stack")


@pytest.mark.parametrize("beta", [0.0, 1.0, -0.5])
def test_dense_alpha_beta_and_empty_c(beta):
    jms, pms = draw([4] * 6, fill=1.0, seed=6, c_fill=0.5)
    run_format("dense", jms, pms, alpha=1.0, beta=beta)
    empty = [jms[0], jms[1], jax_create("C", [4] * 6, [4] * 6).finalize()]
    pempty = [pms[0], pms[1], BlockSparseMatrix("C", [4] * 6, [4] * 6, device="cpu")]
    run_format("dense", empty, pempty, alpha=-2.0, beta=beta)
    run_format("composite", *draw([4] * 6, band=1, seed=7, c_fill=0.0), beta=beta)


@pytest.mark.parametrize("wide", [False, True])
def test_chunked_dense_matches_jax(monkeypatch, wide):
    """The canvas cap shrunk to 512 elements in both packages: the k-, m-
    and n-strips of `_dense_multiply_chunked`, a wide B included."""
    for mod in (jax_mm, mm):
        monkeypatch.setattr(mod, "_DENSE_MAX_CANVAS", 512)
    assert mm._dense_chunking(16, 64, 16, 4, 4, 4) == jax_mm._dense_chunking(16, 64, 16, 4, 4, 4)
    rng = np.random.default_rng(8)
    rbs, cbs = [4] * 8, [4] * (24 if wide else 8)
    full = [(i, j) for i in range(8) for j in range(len(cbs))]
    jms = [operand("A", rbs, patterns(8, band=2), rng),
           operand("B", rbs, full, rng, cols=cbs),
           operand("C", rbs, patterns(8, fill=0.3, rng=rng)[:6], rng, cols=cbs)]
    pms = [port_of(m, m.name) for m in jms]
    _, got = run_format("dense", jms, pms)
    both(mm_dense=False)
    _, ref = run_format("auto", jms, pms)  # the stack format
    assert rel(got, ref) <= 1e-12


def test_dense_general_covers_the_north_star_blocking():
    """434x23 + 18 at small scale: a near-uniform blocking whose last
    block is smaller, with C carved by the padded reshape."""
    sizes = [5] * 9 + [2]
    jms, pms = draw(sizes, fill=0.9, seed=9)
    pc, got = run_format("dense", jms, pms)
    assert len(pc.bins) == 4 and pc.nblks == 100


def test_float32_canvas_gemm_refuses_tf32():
    cuda = torch.device("cuda")
    mm._check_matmul_precision(torch.float32, cuda)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="TF32|float32 GEMMs"):
            mm._check_matmul_precision(torch.float32, cuda)
        mm._check_matmul_precision(torch.float64, cuda)
        mm._check_matmul_precision(torch.float32, torch.device("cpu"))
    finally:
        torch.set_float32_matmul_precision(prev)


# ---------------------------------------------------------- canvas cache
def test_canvas_cache_serves_repeats_and_sees_in_place_writes():
    set_config(mm_format="dense")
    _, (a, b, c) = draw([4] * 6, fill=1.0, seed=10)

    def product():
        out = c.copy()
        mm.multiply("N", "N", 1.0, a, b, 0.0, out)
        return port_tm.to_dense(out)

    first = product()
    canvas = a._dense_canvas[2]
    assert np.array_equal(product(), first) and a._dense_canvas[2] is canvas  # a hit
    pops.scale(a, 2.0)  # in place: the bins' version counters move
    assert np.array_equal(product(), 2.0 * first)
    assert a._dense_canvas[2] is not canvas
    a.bins[0].data[3] = 0.0  # an indexed write into a bin
    np.testing.assert_allclose(product(), port_tm.to_dense(a) @ port_tm.to_dense(b),
                               rtol=1e-12, atol=1e-12)
    a.put_block(0, 0, np.ones((4, 4)))
    a.finalize()  # a structure change drops the canvas
    assert a._dense_canvas is None
    np.testing.assert_allclose(product(), port_tm.to_dense(a) @ port_tm.to_dense(b),
                               rtol=1e-12, atol=1e-12)


def test_canvas_cache_sees_writes_through_the_stack_wrapper():
    """A stack written into a bin of a cached operand (the path the kernels
    take on the card, through `acc.smm.execute_stack`) moves the bin's
    version, so the next dense product rebuilds the canvas."""
    set_config(mm_format="dense")
    _, (a, b, c) = draw([4] * 6, fill=1.0, seed=11)

    def product():
        out = c.copy()
        mm.multiply("N", "N", 1.0, a, b, 0.0, out)
        return port_tm.to_dense(out)

    product()
    canvas, version = a._dense_canvas[2], a.bins[0].data._version
    bdat = b.bins[0].data
    plan = prepare_stack(a.bins[0].data, bdat, bdat, [0, 1], [2, 3], [0, 5])
    execute_stack(a.bins[0].data, bdat, bdat, plan, 0.5)
    assert a.bins[0].data._version > version
    np.testing.assert_allclose(product(), port_tm.to_dense(a) @ port_tm.to_dense(b),
                               rtol=1e-12, atol=1e-12)
    assert a._dense_canvas[2] is not canvas


# ----------------------------------------------------------------- models
def decisions_jax() -> dict:
    return {f"{lb['format']}:{lb['reason']}": int(v) for lb, v in
            jax_metrics.counter_items("dbcsr_tpu_format_decision_total")}


def densities(seed):
    """A density that fills after one product (8 block rows of 3)."""
    jd = jax_purify.make_test_density(8, 3, occ=0.4, seed=seed)
    pd = make_test_density(8, 3, occ=0.4, seed=seed, device="cpu")
    assert np.array_equal(port_tm.to_dense(pd), jax_tm.to_dense(jd))
    return jd, pd


def assert_close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))


@pytest.mark.parametrize("loop", ["purify", "invsqrt"])
def test_loops_match_jax_with_their_formats(loop):
    both(mm_format="auto")
    jd, pd = densities(seed=3)
    if loop == "purify":
        px, ph = mcweeny_purify(pd, steps=5)
        jx, jh = jax_purify.mcweeny_purify(jd, steps=5)
    else:
        js, ps = jd.copy("S"), pd.copy("S")
        jops.add_on_diag(js, 0.5)
        pops.add_on_diag(ps, 0.5)
        ph = []
        px, psf, pit = invsqrt_iteration(ps, tol=1e-10, history=ph)
        jx, jsf, jit = jax_invsqrt.invsqrt_iteration(js, tol=1e-10)
        assert (pit, psf) == (jit, jsf)
        jh = ph  # the JAX loop keeps no history; the iterates are compared
    assert_close(ph, jh)
    assert_close(port_tm.to_dense(px), jax_tm.to_dense(jx))
    formats = mm.read_totals()["formats"]
    assert formats == decisions_jax()
    assert formats.get("dense:heuristic", 0) > 0
