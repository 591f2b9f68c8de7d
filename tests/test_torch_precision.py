"""The port's precision planner (dbcsr_tpu_torch.acc.precision), K1's
demoted forms through their plain version, and the promote loop, held
against the JAX package on the CPU.

A counterpart of each test of `tests/test_precision.py` but the fused
superstack one (superstack is not ported) and the time-series one (no
`obs.timeseries` yet):

* K1's first-use check of each demoted form held to a host oracle of the
  same form, within the rounding of its sums (`form_tolerance`), far
  inside the demotion ceiling;
* each demoted form of the stack kernel's plain version (what a CPU
  tensor runs; on the card K1's forms) within
  `demoted_abft_tolerance` of a float64 oracle, fuzzed, under
  cancellation, and within the same tolerance of the JAX package's
  `_batch_dot` on the same stack; compensation tightens the error;
* `resolve` equal to the JAX package's, evaluated off a TPU (the
  platform the H100 is), for every mode, dtype, tuned column and scope
  or cell state;
* an adaptive multiply under ABFT: demoted, certified, counted, within
  the ceiling of the native product; a sabotaged ceiling promotes the
  cell and re-executes natively, bit for bit the native product, both
  through the deferred flush (beta = 0) and the immediate check;
* the sign loop at 6 block rows of 5 under adaptive + verify in both
  packages: the same schedule of demoted and native steps, converged;
  purify publishes its schedule; a native loop publishes none.

Every test resets both packages' precision cells and scopes, the
config fields it touches, faults, breakers, metrics and events.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbcsr_tpu.acc import precision as jax_precision
from dbcsr_tpu.acc import smm as jax_smm
from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.models.sign import sign_iteration as jax_sign_iteration
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.resilience import breaker as jax_breaker
from dbcsr_tpu.ops import test_methods as jax_tm

from dbcsr_tpu_torch.acc import abft, params, precision, stack_kernel
from dbcsr_tpu_torch.acc import smm as port_smm
from dbcsr_tpu_torch.acc.crosspack import runs
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.mm import multiply as port_mm
from dbcsr_tpu_torch.models import make_test_density, mcweeny_purify, sign_iteration
from dbcsr_tpu_torch.obs import costmodel, events, metrics
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.resilience import breaker, faults

SPECS = [("float32", True), ("float32", False), ("bfloat16", True), ("bfloat16", False)]
_JAX_CFG = ("precision", "abft", "mm_driver", "mm_format", "incremental", "platform_override")
_PORT_CFG = ("precision", "abft", "mm_driver", "mm_format", "incremental")


@pytest.fixture(autouse=True)
def clean(monkeypatch, tmp_path):
    # empty tables: a tuned host row would outrank adaptive demotion
    monkeypatch.setenv("DBCSR_TPU_PARAMS_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("DBCSR_TPU_TORCH_PARAMS_DIR", str(tmp_path / "port"))
    jcfg = {k: getattr(jax_get_config(), k) for k in _JAX_CFG}
    pcfg = {k: getattr(get_config(), k) for k in _PORT_CFG}
    jax_set_config(platform_override="cpu", mm_format="stack", incremental="off")
    set_config(mm_format="stack")
    for mod in (precision, jax_precision):
        mod.reset()
    yield
    for mod in (precision, jax_precision):
        mod.reset()
    faults.clear()
    breaker.reset_board()
    metrics.reset()
    events.clear()
    jax_events.clear()
    jax_metrics.reset()
    jax_breaker.reset_board()
    jax_health.reset()
    abft.discard_pending()
    port_mm.clear_plan_cache()
    jax_set_config(**jcfg)
    set_config(**pcfg)


def _random_stack(rng, na, nb, nc, s, m, n, k):
    a = rng.standard_normal((na, m, k))
    b = rng.standard_normal((nb, k, n))
    ai = rng.integers(0, na, s).astype(np.int32)
    bi = rng.integers(0, nb, s).astype(np.int32)
    ci = np.sort(rng.integers(0, nc, s)).astype(np.int32)
    return a, b, ai, bi, ci


def _oracle(a, b, ai, bi, ci, nc):
    """(f64 product of a zero-C stack, its sum of |terms| scale)."""
    ref = np.zeros((nc, a.shape[1], b.shape[2]))
    np.add.at(ref, ci, np.einsum("smk,skn->smn", a[ai], b[bi]))
    scale = np.zeros_like(ref)
    np.add.at(scale, ci, np.einsum("smk,skn->smn", np.abs(a[ai]), np.abs(b[bi])))
    return ref, max(float(scale.max()), 1e-30)


def _port_stack(a, b, ai, bi, ci, nc, spec, dtype=torch.float64):
    """The stack through the kernel wrapper's plain version (CPU tensors)."""
    run_ptr, run_c = runs(ci)
    i32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int32))  # noqa: E731
    c = torch.zeros((nc, a.shape[1], b.shape[2]), dtype=dtype)
    stack_kernel.smm_stack(c, torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype),
                           i32(ai), i32(bi), i32(run_ptr), i32(run_c), 1.0, precision=spec)
    return c.double().numpy()


def _jax_stack(a, b, ai, bi, ci, nc, spec, dtype=np.float64):
    s = len(ai)
    out = jax_smm._process_stack_xla(
        jnp.zeros((nc, a.shape[1], b.shape[2]), dtype), jnp.asarray(a, dtype),
        jnp.asarray(b, dtype), jnp.asarray(ai.reshape(1, s)), jnp.asarray(bi.reshape(1, s)),
        jnp.asarray(ci.reshape(1, s)), jnp.asarray(1.0, dtype), prec=spec)
    return np.asarray(out, np.float64)


# ------------------------------------------------------------ error bounds
@pytest.mark.parametrize("spec", SPECS)
def test_demoted_stack_error_within_ceiling_fuzzed(spec):
    """Each demoted form within `demoted_abft_tolerance` of the float64
    oracle over fuzzed (m, n, k), and within it of the JAX package's
    `_batch_dot` on the same stack."""
    rng = np.random.default_rng(7)
    for _ in range(6):
        m, n, k = (int(rng.integers(2, 24)) for _ in range(3))
        nc, s = 8, int(rng.integers(40, 300))
        a, b, ai, bi, ci = _random_stack(rng, 12, 11, nc, s, m, n, k)
        got = _port_stack(a, b, ai, bi, ci, nc, spec)
        ref, scale = _oracle(a, b, ai, bi, ci, nc)
        tol = costmodel.demoted_abft_tolerance("float64", spec[0], spec[1], k,
                                               int(np.bincount(ci).max()))
        assert np.abs(got - ref).max() / scale <= tol, (spec, m, n, k)
        jax_out = _jax_stack(a, b, ai, bi, ci, nc, spec)
        assert np.abs(got - jax_out).max() / scale <= tol, (spec, m, n, k)


@pytest.mark.parametrize("spec", [("bfloat16", True), ("bfloat16", False)])
def test_float32_data_demoted_to_bf16_against_jax(spec):
    """float32 data's bf16 forms (float32 accumulation) against the JAX
    package's, at k = 100 (the 100/50/20 blocks' depth)."""
    rng = np.random.default_rng(17)
    a, b, ai, bi, ci = _random_stack(rng, 9, 9, 5, 120, 20, 50, 100)
    got = _port_stack(a, b, ai, bi, ci, 5, spec, dtype=torch.float32)
    want = _jax_stack(a, b, ai, bi, ci, 5, spec, dtype=np.float32)
    _, scale = _oracle(a, b, ai, bi, ci, 5)
    tol = costmodel.demoted_abft_tolerance("float32", spec[0], spec[1], 100,
                                           int(np.bincount(ci).max()))
    assert np.abs(got - want).max() / scale <= tol


@pytest.mark.parametrize("spec", [("float32", True), ("float32", False)])
def test_demoted_stack_cancellation_adversarial(spec):
    """Pairs of entries whose products cancel exactly: what remains is
    demotion rounding, bounded relative to the sum of |terms|."""
    rng = np.random.default_rng(13)
    m = n = k = 9
    na, nc, pairs = 10, 4, 120
    a = rng.standard_normal((2 * na, m, k))
    a[na:] = -a[:na]
    b = rng.standard_normal((na, k, n))
    base = rng.integers(0, na, pairs)
    ai = np.empty(2 * pairs, np.int32)
    ai[0::2], ai[1::2] = base, base + na
    bi = np.repeat(rng.integers(0, na, pairs), 2).astype(np.int32)
    ci = np.sort(np.repeat(rng.integers(0, nc, pairs), 2)).astype(np.int32)
    got = _port_stack(a, b, ai, bi, ci, nc, spec)
    _, scale = _oracle(a, b, ai, bi, ci, nc)
    tol = costmodel.demoted_abft_tolerance("float64", spec[0], spec[1], k,
                                           int(np.bincount(ci).max()))
    assert np.abs(got).max() / scale <= tol


FORMS = [(torch.float64, spec) for spec in SPECS] + [
    (torch.float32, ("bfloat16", True)), (torch.float32, ("bfloat16", False))]


@pytest.mark.parametrize("dtype,spec", FORMS)
def test_first_use_validation_holds_a_demoted_form_to_its_own_oracle(monkeypatch, dtype, spec):
    """K1's first-use check of a demoted form compares it with a host
    oracle of the same form (the same rounded operands), so the form
    passes within the rounding of its sums (`form_tolerance`), and an
    error five times that, still inside the demotion ceiling, fails it."""
    rng = np.random.default_rng(23)
    m, n, k = 5, 6, 7
    a, b, ai, bi, ci = _random_stack(rng, 12, 12, 9, 60, m, n, k)
    at, bt = torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)
    c = torch.zeros((9, m, n), dtype=dtype)
    plan = port_smm.prepare_stack(c, at, bt, ai, bi, ci, variant="kmerge")
    assert plan.driver == "kernel"
    plan.precision = spec
    port_smm._validate_kernel(c, at, bt, plan, ai, bi, ci)
    depth = int(np.bincount(ci).max())
    tol = costmodel.form_tolerance(str(dtype).replace("torch.", ""), spec, k, depth)
    ceiling = costmodel.demoted_abft_tolerance(str(dtype).replace("torch.", ""), *spec, k, depth)
    assert 5 * tol < ceiling
    real = stack_kernel.smm_stack_plain

    def off_by_five_tolerances(c_data, *args, **kw):
        out = real(c_data, *args, **kw)
        out.mul_(1.0 + 5 * tol)
        return out

    monkeypatch.setattr(stack_kernel, "smm_stack_plain", off_by_five_tolerances)
    with pytest.raises(port_smm.KernelValidationError, match="compute"):
        port_smm._validate_kernel(c, at, bt, plan, ai, bi, ci)


def test_compensation_tightens_the_bound():
    rng = np.random.default_rng(3)
    a, b, ai, bi, ci = _random_stack(rng, 10, 10, 6, 200, 13, 13, 13)
    ref, scale = _oracle(a, b, ai, bi, ci, 6)

    def err(spec):
        return np.abs(_port_stack(a, b, ai, bi, ci, 6, spec) - ref).max() / scale

    assert err(("float32", True)) < err(("float32", False)) / 100.0


# ----------------------------------------------------------------- planner
def test_native_mode_resolves_none():
    assert get_config().precision == "native"
    assert precision.resolve(23, 23, 23, torch.float64) is None


def test_adaptive_requires_abft():
    set_config(precision="adaptive", abft="off")
    assert precision.resolve(23, 23, 23, torch.float64) is None
    set_config(abft="verify")
    assert precision.resolve(23, 23, 23, torch.float64) == ("float32", False)
    assert precision.resolve(23, 23, 23, torch.float32) is None  # bf16 demotion is TPU-only


def test_forced_modes_and_complex_ineligible():
    set_config(precision="f32")
    assert precision.resolve(8, 8, 8, torch.float64) == ("float32", True)
    assert precision.resolve(8, 8, 8, torch.float32) is None
    assert precision.resolve(8, 8, 8, torch.complex128) is None
    set_config(precision="bf16")
    assert precision.resolve(8, 8, 8, torch.float32) == ("bfloat16", True)
    assert precision.resolve(8, 8, 8, torch.bfloat16) is None


@pytest.mark.parametrize("mode", ["native", "adaptive", "f32", "bf16"])
@pytest.mark.parametrize("abft_mode", ["off", "verify"])
def test_resolve_equals_the_reference_off_a_tpu(mode, abft_mode):
    """The port's resolve is the JAX package's as it evaluates off a TPU,
    for every dtype, tuned column and scope state."""
    set_config(precision=mode, abft=abft_mode)
    jax_set_config(precision=mode, abft=abft_mode)
    tuned_rows = [None, {"precision": "native"}] + [{"precision": c} for c in
                                                    ("f32", "f32c", "bf16", "bf16c", "x")]
    for dtype in (np.float64, np.float32, np.complex128, np.complex64):
        for tuned in tuned_rows:
            for scope in (None, "native"):
                args = (23, 23, 23)
                if scope is None:
                    got = precision.resolve(*args, dtype, tuned=tuned)
                    want = jax_precision.resolve(*args, dtype, tuned=tuned)
                else:
                    with precision.chain_scope("t", dtype=np.float64) as ps, \
                            jax_precision.chain_scope("t", dtype=np.float64) as js:
                        ps.mode = js.mode = "native"
                        got = precision.resolve(*args, dtype, tuned=tuned)
                        want = jax_precision.resolve(*args, dtype, tuned=tuned)
                assert got == want, (mode, abft_mode, dtype, tuned, scope)
    # a promoted cell resolves native in both
    for mod, dt in ((precision, "float64"), (jax_precision, "float64")):
        mod.note_exceeded([(5, 5, 5, dt)], 1e-3, 1e-6)
    assert precision.resolve(5, 5, 5, np.float64) == jax_precision.resolve(5, 5, 5, np.float64)
    assert precision.plan_token()[0] == mode


def test_params_precision_column_overrides():
    set_config(precision="adaptive", abft="verify")
    assert precision.resolve(9, 9, 9, torch.float64, tuned={"precision": "native"}) is None
    assert precision.resolve(9, 9, 9, torch.float64, tuned={"precision": "f32"}) == \
        ("float32", False)
    assert precision.resolve(9, 9, 9, torch.float64, tuned={"precision": "f32c"}) == \
        ("float32", True)
    assert precision.resolve(9, 9, 9, torch.float32, tuned={"precision": "f32"}) is None
    with pytest.raises(ValueError, match="precision column"):
        params.save_entry({"m": 9, "n": 9, "k": 9, "dtype": "float64", "stack_size": 0,
                           "driver": "pallas", "precision": "f16"})


def test_promoted_cell_resolves_native_and_bumps_generation():
    set_config(precision="adaptive", abft="verify")
    gen0 = precision.generation()
    cell = (23, 23, 23, "float64")
    assert precision.resolve(23, 23, 23, torch.float64) is not None
    precision.note_exceeded([cell], 1e-3, 1e-6)
    assert precision.resolve(23, 23, 23, torch.float64) is None
    assert precision.generation() > gen0
    assert precision.cells_snapshot()[cell]["state"] == "promoted"
    assert metrics.counter_items("dbcsr_tpu_precision_promotions_total") == [
        ({"dtype": "float64"}, 1.0)]


# ---------------------------------------------------- engine certification
def _pair(seed, nblk=6, bs=5, occ=0.6):
    rng = np.random.default_rng(seed)
    sizes = [bs] * nblk
    return [port_tm.make_random_matrix(n, sizes, sizes, occupation=occ, rng=rng, device="cpu")
            for n in "AB"]


def _product(a, b, beta=0.0, c0=None):
    c = (c0.copy() if c0 is not None
         else BlockSparseMatrix("C", a.row_blk_sizes, b.col_blk_sizes, a.dtype, device="cpu"))
    port_mm.multiply("N", "N", 1.0, a, b, beta, c)
    return port_tm.to_dense(c)


def test_adaptive_multiply_certified_and_counted():
    a, b = _pair(21)
    ref = _product(a, b)
    set_config(precision="adaptive", abft="verify")
    got = _product(a, b)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert 0 < err < costmodel.demoted_abft_tolerance("float64", "float32", False, 5, 8)
    cells = precision.cells_snapshot()
    assert cells and all(i["state"] == "demoted" and i["launches"] >= 1 for i in cells.values())
    launched = metrics.counter_items("dbcsr_tpu_precision_launches_total")
    assert launched == [({"requested": "float64", "compute": "float32",
                          "compensated": "false"}, 1.0)]
    assert not metrics.counter_items("dbcsr_tpu_abft_mismatches_total")


@pytest.mark.parametrize("mode,spec", [("f32", ("float32", True)), ("bf16", ("bfloat16", True))])
def test_forced_modes_multiply(mode, spec):
    """The forced modes demote with compensation and no certificate; the
    plan-cache key follows the mode (a native repeat re-plans)."""
    a, b = _pair(23)
    ref = _product(a, b)
    set_config(precision=mode)
    got = _product(a, b)
    tol = costmodel.demoted_abft_tolerance("float64", *spec, 5, 8)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= tol
    assert metrics.counter_items("dbcsr_tpu_precision_launches_total")[0][0]["compute"] == spec[0]
    set_config(precision="native")
    np.testing.assert_array_equal(_product(a, b), ref)


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_probe_ceiling_breach_promotes_and_reexecutes(monkeypatch, beta):
    """A sabotaged ceiling: every demoted probe breaches, the cell
    promotes, the plan re-executes natively in place, bit for bit the
    native engine; later products resolve native up front.  beta = 0
    takes the deferred flush, beta = 0.5 the immediate check."""
    a, b = _pair(31)
    c0 = _pair(33)[0]
    ref = _product(a, b, beta, c0)
    set_config(precision="adaptive", abft="verify")
    monkeypatch.setattr(costmodel, "demoted_abft_tolerance", lambda *args: 1e-30)
    got = _product(a, b, beta, c0)
    monkeypatch.undo()
    np.testing.assert_array_equal(got, ref)
    cells = precision.cells_snapshot()
    assert cells and all(i["state"] == "promoted" for i in cells.values())
    assert precision.resolve(5, 5, 5, torch.float64) is None
    evs = events.records(kind="precision_promote")
    assert evs and evs[-1]["why"] == "probe-ceiling"
    assert events.records(kind="precision_promote_reexec")
    # a promote is no corruption: no failure, no fallback, no mismatch
    for name in ("dbcsr_tpu_driver_failures_total", "dbcsr_tpu_driver_fallback_total",
                 "dbcsr_tpu_abft_mismatches_total", "dbcsr_tpu_abft_recoveries_total"):
        assert not metrics.counter_items(name), name
    np.testing.assert_array_equal(_product(a, b, beta, c0), ref)


def test_tuned_host_row_outranks_adaptive_not_forced():
    a, b = _pair(41)
    params.save_entry({"m": 5, "n": 5, "k": 5, "dtype": "float64", "stack_size": 0,
                       "driver": "host", "gflops": 1.0})
    set_config(precision="adaptive", abft="verify")
    _product(a, b)
    assert not metrics.counter_items("dbcsr_tpu_precision_launches_total")
    set_config(precision="f32")
    _product(a, b)
    assert metrics.counter_items("dbcsr_tpu_precision_launches_total")


# ---------------------------------------------------------- chain schedule
def _schedule(evs):
    return [(e["step"], e["precision"], bool(e.get("promoted"))) for e in evs]


def test_sign_loop_schedule_matches_jax():
    """The sign loop at 6 block rows of 5 under adaptive + verify in both
    packages, with the format planner on (its products go dense once the
    iterate fills, as in the JAX package's own test): the same schedule
    of demoted and native steps, each loop converged to the native
    loop's tolerance.  (On the stack format alone both packages'
    demoted opening steps leave float32 rounding in this matrix's null
    space, which the native steps then grow by 3/2 a step: neither
    converges in 60 steps.)"""
    rng_seed = 9
    pa = port_tm.make_random_matrix("A", [5] * 6, [5] * 6, occupation=0.6, matrix_type="S",
                                    rng=np.random.default_rng(rng_seed), device="cpu")
    ja = jax_tm.make_random_matrix("A", [5] * 6, [5] * 6, occupation=0.6, matrix_type="S",
                                   rng=np.random.default_rng(rng_seed))
    set_config(precision="adaptive", abft="verify", mm_format="auto")
    jax_set_config(precision="adaptive", abft="verify", mm_format="auto")
    _, hist = sign_iteration(pa, steps=60, tol=1e-11)
    _, jhist = jax_sign_iteration(ja, steps=60, tol=1e-11)
    evs = events.records(kind="precision_schedule")
    jevs = jax_events.records(kind="precision_schedule")
    assert evs and evs[0]["precision"] == "demoted" and evs[-1]["precision"] == "native"
    assert _schedule(evs) == _schedule(jevs)
    assert sum(e.get("promoted", False) for e in evs) == 1
    assert hist[-1] < 1e-11 and jhist[-1] < 1e-11 and len(hist) == len(jhist)


def test_purify_chain_publishes_schedule():
    set_config(precision="adaptive", abft="verify")
    p = make_test_density(6, 5, occ=0.4, seed=3, device="cpu")
    mcweeny_purify(p, steps=4)
    evs = events.records(kind="precision_schedule")
    assert evs and evs[0]["precision"] == "demoted"
    assert all(e["chain"] == "purify" for e in evs)


def test_chain_scope_inert_when_native():
    p = make_test_density(4, 5, occ=0.4, seed=4, device="cpu")
    mcweeny_purify(p, steps=3)
    assert not events.records(kind="precision_schedule")
    token = precision.plan_token()
    with precision.chain_scope("x", dtype=torch.float64) as sc:
        assert not sc.active and precision.plan_token() == token


def test_kernel_validation_tolerance_is_dtype_aware():
    bf16 = costmodel.kernel_validation_tolerance("bfloat16", 23, 16)
    f32 = costmodel.kernel_validation_tolerance("float32", 23, 16)
    f64 = costmodel.kernel_validation_tolerance("float64", 23, 16)
    assert f64 < f32 < bf16
    assert 1e-2 < bf16 < 0.5
    assert costmodel.kernel_validation_tolerance("complex128", 23, 16) == f64


def test_form_tolerance_follows_the_accumulator():
    """A compensated form sums in the data's dtype; an uncompensated one
    sums each k-deep product in float32 and, for float64 data, the run in
    float64; the native form is the kernel validation tolerance."""
    kvt = costmodel.kernel_validation_tolerance
    ft = costmodel.form_tolerance
    assert ft("float64", None, 23, 5000) == kvt("float64", 23, 5000)
    assert ft("float64", ("float32", True), 23, 5000) == kvt("float64", 23, 5000)
    assert ft("float64", ("bfloat16", True), 23, 5000) == kvt("float64", 23, 5000)
    assert ft("float64", ("float32", False), 23, 5000) == kvt("float32", 23, 1)
    assert ft("float64", ("bfloat16", False), 23, 5000) == kvt("float32", 23, 1)
    assert ft("float32", ("bfloat16", False), 23, 5000) == kvt("float32", 23, 5000)
    for dtype, spec in FORMS:
        name = str(dtype).replace("torch.", "")
        assert ft(name, spec, 23, 5000) < costmodel.demoted_abft_tolerance(name, *spec, 23, 5000)
