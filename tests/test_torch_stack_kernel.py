"""The port's stack function (dbcsr_tpu_torch.acc.smm.process_stack) held
against the JAX package's stack kernels on the same numpy-seeded inputs.

On the CPU the port runs the plain PyTorch version of its CUDA kernel;
the JAX side runs the Pallas kernel in interpret mode (f32/bf16, base
and k-merged variants) and the XLA stack driver (f64).  Tolerance: the
shared `kernel_validation_tolerance` of the dtype, the k depth and the
longest run, relative to max(|reference|, 1); f64 also at <= 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbcsr_tpu.acc import pallas_smm as jax_pallas
from dbcsr_tpu.acc import smm as jax_smm
from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.obs.costmodel import kernel_validation_tolerance as jax_tolerance
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries

from dbcsr_tpu_torch.acc import smm as port_smm
from dbcsr_tpu_torch.acc import stack_kernel
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.obs import metrics
from dbcsr_tpu_torch.obs.costmodel import kernel_validation_tolerance
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


SHAPES = [(23, 23, 23), (5, 13, 23), (18, 23, 18)]
ALPHA = -1.25


@pytest.fixture(autouse=True)
def clean_resilience():
    """A failure a test provokes leaves no breaker open, no fault spec, no
    counter and no demoted shape behind."""
    demoted = set(port_smm._cross_disabled)
    faults.clear()
    breaker.reset_board()
    metrics.reset()
    yield
    faults.clear()
    breaker.reset_board()
    metrics.reset()
    port_smm._cross_disabled.clear()
    port_smm._cross_disabled.update(demoted)


def _stack(seed, m, n, k, long_run=40):
    """f64 operands with one trailing zero row each (the JAX engine's pad
    row), a nonzero C, and a sorted stack of short runs plus one long run."""
    rng = np.random.default_rng(seed)
    na, nb, nc = 30, 26, 20
    a = np.concatenate([rng.standard_normal((na, m, k)), np.zeros((1, m, k))])
    b = np.concatenate([rng.standard_normal((nb, k, n)), np.zeros((1, k, n))])
    c = rng.standard_normal((nc, m, n))
    lens = rng.integers(1, 4, size=nc)
    lens[nc // 2] = long_run
    ci = np.repeat(np.arange(nc), lens).astype(np.int32)
    ai = rng.integers(0, na, size=len(ci)).astype(np.int32)
    bi = rng.integers(0, nb, size=len(ci)).astype(np.int32)
    return a, b, c, ai, bi, ci, int(lens.max())


def _port(a, b, c, ai, bi, ci, dtype, variant=None):
    t = [torch.from_numpy(x).to(dtype) for x in (a, b, c)]
    out = port_smm.process_stack(t[2], t[0], t[1], ai, bi, ci, ALPHA, variant=variant)
    return out.float().numpy().astype(np.float64) if dtype == torch.bfloat16 \
        else out.numpy().astype(np.float64)


def _rel(got, want):
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1.0)


@pytest.fixture
def jax_config_restored():
    cfg = jax_get_config()
    prev = (cfg.mm_driver, cfg.validate_kernels)
    yield
    jax_set_config(mm_driver=prev[0], validate_kernels=prev[1])


@pytest.mark.parametrize("variant", [None, "kmerge"])
@pytest.mark.parametrize("mnk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_matches_pallas_kernel(dtype, mnk, variant):
    m, n, k = mnk
    a, b, c, ai, bi, ci, depth = _stack(11, m, n, k)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    # both packages round the same float32 values to bf16 (nearest-even)
    a32, b32, c32 = (x.astype(np.float32) for x in (a, b, c))
    want = np.asarray(jax_pallas.process_stack_pallas(
        jnp.asarray(c32, jdt), jnp.asarray(a32, jdt), jnp.asarray(b32, jdt),
        ai, bi, ci, ALPHA, a_pad_row=a.shape[0] - 1, b_pad_row=b.shape[0] - 1,
        grouping=4 if variant else None, variant=variant), np.float64)
    got = _port(a32, b32, c32, ai, bi, ci, tdt, variant=variant)
    tol = kernel_validation_tolerance(dtype, k, depth)
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("mnk", SHAPES)
def test_stack_f64_matches_xla_driver(mnk, jax_config_restored):
    m, n, k = mnk
    a, b, c, ai, bi, ci, depth = _stack(12, m, n, k)
    jax_set_config(mm_driver="xla")
    want = np.asarray(jax_smm.process_stack(jnp.asarray(c), jnp.asarray(a),
                                            jnp.asarray(b), ai, bi, ci, ALPHA))
    got = _port(a, b, c, ai, bi, ci, torch.float64)
    rel = _rel(got, want)
    assert rel <= 1e-12
    assert rel <= kernel_validation_tolerance("float64", k, depth)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("k", [5, 23, 100])
@pytest.mark.parametrize("depth", [1, 40, 5000])
def test_tolerance_copy_matches_reference(dtype, k, depth):
    assert kernel_validation_tolerance(dtype, k, depth) == jax_tolerance(dtype, k, depth)


def test_plain_version_runs_on_cpu_without_counting_launches():
    a, b, c, ai, bi, ci, _ = _stack(13, 5, 13, 23)
    stack_kernel.reset_counts()
    _port(a, b, c, ai, bi, ci, torch.float64)
    assert stack_kernel.launches == 0
    assert stack_kernel.plain_calls >= 1


def test_run_layout_of_prepared_stack():
    a, b, c, ai, bi, ci, depth = _stack(14, 5, 13, 23)
    t = [torch.from_numpy(x) for x in (a, b, c)]
    plan = port_smm.prepare_stack(t[2], t[0], t[1], ai, bi, ci)
    run_ptr = plan.run_ptr.numpy()
    assert plan.entries == len(ci) and plan.max_run == depth
    assert np.array_equal(plan.run_c.numpy(), np.unique(ci))
    assert np.array_equal(np.diff(run_ptr), np.bincount(ci))
    assert port_smm.prepare_stack(t[2], t[0], t[1], [], [], []) is None
    with pytest.raises(ValueError, match="sorted"):
        port_smm.prepare_stack(t[2], t[0], t[1], ai, bi, ci[::-1].copy())
    with pytest.raises(IndexError):
        port_smm.prepare_stack(t[2], t[0], t[1], ai + 1000, bi, ci)


def test_wrapper_rejects_mismatched_arguments():
    a, b, c, ai, bi, ci, _ = _stack(15, 5, 13, 23)
    t = [torch.from_numpy(x) for x in (a, b, c)]
    plan = port_smm.prepare_stack(t[2], t[0], t[1], ai, bi, ci)
    args = (plan.a_idx, plan.b_idx, plan.run_ptr, plan.run_c)
    with pytest.raises(TypeError):
        stack_kernel.smm_stack(t[2], t[0].float(), t[1], *args)
    with pytest.raises(TypeError):
        stack_kernel.smm_stack(t[2], t[0], t[1], plan.a_idx.long(), *args[1:])
    with pytest.raises(ValueError):
        stack_kernel.smm_stack(t[2], t[1], t[0], *args)
    with pytest.raises(ValueError, match="unknown stack kernel variant"):
        port_smm.process_stack(t[2], t[0], t[1], ai, bi, ci, variant="crosspack_v2")


def test_first_use_validation_raises_on_corrupted_plain_version(monkeypatch):
    """A kernel proven wrong by its first-use oracle reaches the caller:
    the failure is counted and quarantines the shape, nothing fails over,
    and C is left as it was (the oracle runs before the launch)."""
    a, b, c, ai, bi, ci, _ = _stack(16, 5, 13, 23)
    real = stack_kernel.smm_stack_plain

    def corrupted(c_data, *args, **kw):
        out = real(c_data, *args, **kw)
        out += 1.0
        return out

    monkeypatch.setattr(stack_kernel, "smm_stack_plain", corrupted)
    monkeypatch.setattr(port_smm, "_validated_kernels", set())
    t = [torch.from_numpy(x) for x in (a, b, c)]
    c_before = t[2].clone()
    with pytest.raises(port_smm.KernelValidationError):
        port_smm.process_stack(t[2], t[0], t[1], ai, bi, ci, ALPHA)
    assert torch.equal(t[2], c_before)
    assert metrics.counter_items("dbcsr_tpu_driver_failures_total") == [
        ({"driver": "pallas", "kind": "validation"}, 1.0)]
    assert metrics.counter_items("dbcsr_tpu_driver_fallback_total") == []
    assert breaker.get_board().state("pallas", (5, 13, 23, "float64")) == breaker.OPEN


@pytest.mark.parametrize("on_card", [False, True])
def test_first_use_validation_failure_never_fails_over(monkeypatch, on_card):
    """A kernel that fails its first-use check never gives way to another
    driver, on the CPU's chain as on the card's: it raises, and so does
    a failover candidate that fails its own check (the JAX package fails
    such a kernel over, `dbcsr_tpu/acc/smm.py:1260-1345`)."""
    monkeypatch.setattr(port_smm, "_on_card", lambda c_data: on_card)
    a, b, c, ai, bi, ci, _ = _stack(16, 5, 13, 23)
    real = stack_kernel.smm_stack

    def corrupted(c_data, *args, **kw):
        out = real(c_data, *args, **kw)
        out += 1.0
        return out

    monkeypatch.setattr(stack_kernel, "smm_stack", corrupted)
    monkeypatch.setattr(port_smm, "_validated_kernels", set())
    t = [torch.from_numpy(x) for x in (a, b, c)]
    plan = port_smm.prepare_stack(t[2], t[0], t[1], ai, bi, ci)
    assert plan.driver == "kernel"
    stack_kernel.reset_counts()
    got = t[2].clone()
    with pytest.raises(port_smm.KernelValidationError):
        port_smm.execute_stack(got, t[0], t[1], plan, ALPHA)
    assert torch.equal(got, t[2]) and plan.driver == "kernel"
    assert stack_kernel.plain_calls == 1  # the oracle's launch, on a scratch C
    assert metrics.counter_items("dbcsr_tpu_driver_failures_total") == [
        ({"driver": "pallas", "kind": "validation"}, 1.0)]
    assert metrics.counter_items("dbcsr_tpu_driver_fallback_total") == []
    # a K1 failure other than validation fails over; K1 failing its own
    # check as the candidate still raises
    monkeypatch.setattr(port_smm, "_validated_kernels", set())
    breaker.reset_board()
    metrics.reset()
    set_config(mm_driver="pallas_cross")
    try:
        cplan = port_smm.prepare_stack(t[2], t[0], t[1], ai, bi, ci)
        assert cplan.driver == "crosspack"
        with faults.inject_faults("pallas_cross:raise,times=1"):
            with pytest.raises(port_smm.KernelValidationError):
                port_smm.execute_stack(got, t[0], t[1], cplan, ALPHA)
    finally:
        set_config(mm_driver="auto")
    assert torch.equal(got, t[2])
    assert dict((lab["driver"] + ":" + lab["kind"], v) for lab, v in
                metrics.counter_items("dbcsr_tpu_driver_failures_total")) == {
        "pallas_cross:runtime": 1.0, "pallas:validation": 1.0}
    assert metrics.counter_items("dbcsr_tpu_driver_fallback_total") == []


def test_card_stack_never_runs_the_plain_driver(monkeypatch):
    """On the card the chain holds the hand-written kernels only (a
    patched `_on_card` stands in for CUDA tensors): a failed K1 launch
    fails over to the crosspack kernel, and when no kernel admits the
    stack the launch raises and C is left as it was."""
    monkeypatch.setattr(port_smm, "_on_card", lambda c_data: True)
    a, b, c, ai, bi, ci, _ = _stack(18, 23, 23, 23)
    t = [torch.from_numpy(x) for x in (a, b, c)]
    key = (23, 23, 23, "float64")
    prev = get_config().validate_kernels
    set_config(validate_kernels=False)
    try:
        assert port_smm._chain_candidates("pallas", t[2]) == ["pallas_cross"]
        assert port_smm._chain_candidates("pallas_cross", t[2]) == ["pallas"]
        want = port_smm.process_stack(t[2].clone(), t[0], t[1], ai, bi, ci, ALPHA)
        got = t[2].clone()
        stack_kernel.reset_counts()
        with faults.inject_faults("pallas:raise,times=1") as sp:
            port_smm.process_stack(got, t[0], t[1], ai, bi, ci, ALPHA)
        assert sp[0].fired == 1 and stack_kernel.plain_calls == 0
        torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)
        assert metrics.counter_items("dbcsr_tpu_driver_fallback_total") == [
            ({"from": "pallas", "to": "pallas_cross"}, 1.0)]
        # no kernel admits the stack: K1 fails, crosspack is demoted for
        # the shape, and the plain version is never a candidate
        breaker.reset_board()
        metrics.reset()
        port_smm._cross_disabled.add(key)
        got = t[2].clone()
        with faults.inject_faults("pallas:raise") as sp:
            with pytest.raises(RuntimeError, match="injected"):
                port_smm.process_stack(got, t[0], t[1], ai, bi, ci, ALPHA)
        assert sp[0].fired == 2  # the launch and its last-resort retry
        assert torch.equal(got, t[2]) and stack_kernel.plain_calls == 0
        assert metrics.counter_items("dbcsr_tpu_driver_fallback_total") == []
    finally:
        port_smm._cross_disabled.discard(key)
        set_config(validate_kernels=prev)


def test_validation_passes_and_is_cached(monkeypatch):
    a, b, c, ai, bi, ci, _ = _stack(17, 18, 23, 18)
    monkeypatch.setattr(port_smm, "_validated_kernels", set())
    t = [torch.from_numpy(x) for x in (a, b, c)]
    port_smm.process_stack(t[2], t[0], t[1], ai, bi, ci, ALPHA)
    assert port_smm._validated_kernels == {(18, 23, 18, "float64", "cpu")}
