"""K1's complex and demoted forms (dbcsr_tpu_torch/acc/stack_kernel.py)
held against the JAX package on the CPU.

On a CPU tensor the stack kernel's wrapper runs its plain version, which
computes each form as the JAX package's `_batch_dot` does
(`dbcsr_tpu/acc/smm.py:88-124`); on the card the same wrapper launches
the hand-written forms of ``csrc/smm_stack.cu``, which `chip_smoke.py`
holds against this plain version.  Here, the same operands, made from a
numpy seed, go through the port's wrapper and the JAX package's XLA
stack driver (`_process_stack_xla`):

* every demoted spec and both complex kinds (complex alpha), at one
  shape of each register class of the warp path (2, 3 and 4 tiles of 8
  rows: (1,1,1), (5,13,7), (8,8,8), (23,23,23), (24,24,24), (32,32,32),
  (7,32,1)) and three of the tiled path ((33,23,23), (100,50,20) and the
  RI contraction's (529,23,23)), on runs of 1-16 entries, within the
  form's `form_tolerance`;
* `stack_bound_s` at the north star's, `test_H2O`'s and the RI
  contraction's stacks as the smoke measured them on the H100 (their
  counts below), and a compensated spec's threefold operation count;
* the units each form's products run on (`form_units`, the same on both
  paths), for every form the kernel takes.
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbcsr_tpu.acc import smm as jax_smm
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries

from dbcsr_tpu_torch.acc import stack_kernel
from dbcsr_tpu_torch.acc.crosspack import runs
from dbcsr_tpu_torch.obs import costmodel


@pytest.fixture(autouse=True)
def reset_jax_plane():
    """The JAX package's runs in these tests feed its metrics, health
    model, events and telemetry store: all four are reset after every
    test, so a later file in the same worker (`tests/test_tune.py`'s
    admission checks) does not start from a DEGRADED or CRITICAL
    verdict."""
    yield
    for reset in (jax_metrics.reset, jax_health.reset, jax_events.clear, jax_timeseries.reset):
        reset()


DEMOTED = [(torch.float64, ("float32", False)), (torch.float64, ("float32", True)),
           (torch.float64, ("bfloat16", False)), (torch.float64, ("bfloat16", True)),
           (torch.float32, ("bfloat16", False)), (torch.float32, ("bfloat16", True))]
COMPLEX = [(torch.complex64, None), (torch.complex128, None)]
# warp path: register classes 2 ((1,1,1), (5,13,7), (8,8,8)), 3
# ((23,23,23), (24,24,24)) and 4 ((32,32,32), (7,32,1)); tiled path:
# (33,23,23), (100,50,20) and (529,23,23), the RI contraction's stacks
# (their C blocks cut into two chunks of row tiles by the complex and
# demoted forms)
SHAPES = [(1, 1, 1), (5, 13, 7), (8, 8, 8), (23, 23, 23), (24, 24, 24), (32, 32, 32),
          (7, 32, 1), (33, 23, 23), (100, 50, 20), (529, 23, 23)]
_NP = {torch.float64: np.float64, torch.float32: np.float32,
       torch.complex64: np.complex64, torch.complex128: np.complex128}


def _form_id(form):
    return stack_kernel.form_name(*form)


def _stack(rng, m, n, k, dtype, nc=6, na=9, nb=8):
    """Operands and a sorted stack: ``nc`` C blocks with runs of 1-16
    entries, complex values for a complex dtype."""
    def values(shape):
        x = rng.standard_normal(shape)
        return x + 1j * rng.standard_normal(shape) if dtype.is_complex else x
    a, b, c0 = values((na, m, k)), values((nb, k, n)), values((nc, m, n))
    lens = rng.integers(1, 17, size=nc)
    ci = np.repeat(np.arange(nc), lens).astype(np.int32)
    ai = rng.integers(0, na, len(ci)).astype(np.int32)
    bi = rng.integers(0, nb, len(ci)).astype(np.int32)
    return a, b, c0, ai, bi, ci, int(lens.max())


def _port(a, b, c0, ai, bi, ci, alpha, dtype, spec):
    """The stack through the kernel wrapper on CPU tensors (its plain
    version), in place on C."""
    run_ptr, run_c = runs(ci)
    i32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int32))  # noqa: E731
    c = torch.from_numpy(c0).to(dtype).clone()
    stack_kernel.smm_stack(c, torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype),
                           i32(ai), i32(bi), i32(run_ptr), i32(run_c), alpha, precision=spec)
    return c.numpy().astype(np.complex128 if dtype.is_complex else np.float64)


def _jax(a, b, c0, ai, bi, ci, alpha, dtype, spec):
    """The same stack through the JAX package's XLA stack driver."""
    dt = _NP[dtype]
    s = len(ai)
    out = jax_smm._process_stack_xla(
        jnp.asarray(c0.astype(dt)), jnp.asarray(a.astype(dt)), jnp.asarray(b.astype(dt)),
        jnp.asarray(ai.reshape(1, s)), jnp.asarray(bi.reshape(1, s)),
        jnp.asarray(ci.reshape(1, s)), jnp.asarray(alpha, dt), prec=spec)
    return np.asarray(out).astype(np.complex128 if dtype.is_complex else np.float64)


@pytest.mark.parametrize("form", DEMOTED + COMPLEX, ids=_form_id)
@pytest.mark.parametrize("mnk", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_form_against_jax_batch_dot(mnk, form):
    """One form at one block shape: the port's plain version and the JAX
    package's `_batch_dot` stack on the same operands agree within the
    rounding of the form's sums (`form_tolerance` at k and the longest
    run); complex forms with a complex alpha."""
    dtype, spec = form
    m, n, k = mnk
    rng = np.random.default_rng(zlib.crc32(f"{mnk}{_form_id(form)}".encode()))
    a, b, c0, ai, bi, ci, longest = _stack(rng, m, n, k, dtype)
    alpha = 0.75 - 0.5j if dtype.is_complex else -0.75
    got = _port(a, b, c0, ai, bi, ci, alpha, dtype, spec)
    want = _jax(a, b, c0, ai, bi, ci, alpha, dtype, spec)
    rel = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1.0)
    tol = costmodel.form_tolerance(str(dtype).replace("torch.", ""), spec, k, longest)
    assert rel <= tol, (f"{_form_id(form)} {mnk}: rel {rel:.3e} against the JAX package "
                        f"> form_tolerance {tol:.3e}")


# The north star's stacks (10,000^2, 23x23 blocks and a last 18, occupancy
# 0.1), per span: (m, n, k, entries, A blocks, B blocks, runs), as the
# smoke's `*_stacks` lines counted them on the H100; the complex kinds
# draw their own pattern.  `test_H2O` (2208^2, 23x23 blocks) is one
# stack of 566,340 entries in 9216 runs.
NORTHSTAR_F64 = [(18, 18, 23, 7, 7, 7, 1), (18, 23, 23, 2098, 48, 2098, 432),
                 (23, 18, 23, 2102, 2102, 47, 432), (23, 23, 18, 2704, 52, 52, 2704),
                 (23, 23, 23, 825573, 19015, 18859, 186045)]
NORTHSTAR_COMPLEX = [(18, 18, 23, 6, 6, 6, 1), (18, 23, 23, 2073, 48, 2073, 430),
                     (23, 18, 23, 1648, 1648, 37, 425), (23, 23, 18, 2600, 52, 50, 2600),
                     (23, 23, 23, 823251, 19015, 18762, 186085)]
H2O = (23, 23, 23, 566340, 7366, 7379, 9216)
# The RI contraction's stacks, summed over its TAS groups: (529,23,23)
# products, T's blocks, M's blocks, C's blocks, at full width (96
# molecules; the adaptive leg) and at the complex128 leg's 84 molecules
RI_96 = (529, 23, 23, 943698, 43526, 2008, 190965)
RI_84 = (529, 23, 23, 550036, 28972, 1528, 125808)


def _bound_ms(dtype, spans, precision=None):
    out = [costmodel.stack_bound_s(dtype, *sp, precision=precision) for sp in spans]
    return sum(t for t, _ in out) * 1e3, max(out)[1]


@pytest.mark.parametrize("dtype,spans,precision,ms,by", [
    ("complex128", NORTHSTAR_COMPLEX, None, 1.22, "operations"),
    ("complex64", NORTHSTAR_COMPLEX, None, 1.21, "operations"),
    ("float64", NORTHSTAR_F64, ("float32", False), 0.534, "bytes"),
    ("float32", [H2O], ("bfloat16", True), 0.042, "operations"),
    ("float64", [RI_96], ("float32", False), 12.367, "bytes"),
    ("complex128", [RI_84], None, 18.379, "operations"),
], ids=["c8_northstar", "c4_northstar", "f64_f32_northstar", "f32_bf16c_h2o",
        "f64_f32_ri", "c8_ri_84"])
def test_stack_bound_at_the_measured_stacks(dtype, spans, precision, ms, by):
    """`stack_bound_s` summed over a product's stacks gives the bounds
    `PERF.md` reports beside the forms' times, bound by what it says
    (the largest stack's bound decides)."""
    got, got_by = _bound_ms(dtype, spans, precision)
    assert got == pytest.approx(ms, abs=0.005)
    assert got_by == by


@pytest.mark.parametrize("dtype,compute", [("float64", "float32"), ("float64", "bfloat16"),
                                           ("float32", "bfloat16")])
def test_compensated_spec_triples_the_operations(dtype, compute):
    """A compensated spec does three products at the compute dtype's
    peak: at an operation-bound stack its bound is three times the
    uncompensated one, and the bytes are the same."""
    stack = (23, 23, 23, 10**7, 10, 10, 10)
    plain, by_plain = costmodel.stack_bound_s(dtype, *stack, precision=(compute, False))
    comp, by_comp = costmodel.stack_bound_s(dtype, *stack, precision=(compute, True))
    ops = 2.0 * 23**3 * 10**7
    assert by_plain == by_comp == "operations"
    assert plain == pytest.approx(ops / costmodel.H100_PEAK_FLOPS[compute])
    assert comp == pytest.approx(3 * plain)


def test_every_form_names_its_units():
    """Every form the kernel takes names the units its products run on,
    on both paths: DMMA for f64 products (native, complex128 and the f64
    data's compensated forms), the bf16 tensor cores for uncompensated
    bf16 and f32 data's compensated bf16, f32 FMAs otherwise."""
    forms = [(dt, None) for dt in (torch.float64, torch.float32, torch.bfloat16,
                                   torch.complex64, torch.complex128)] + DEMOTED
    units = {stack_kernel.form_name(dt, spec): stack_kernel.form_units(dt, spec)
             for dt, spec in forms}
    for dt, spec in forms:
        assert stack_kernel.compute_code(dt, spec) in range(5)
    assert units == {
        "float64": "dmma", "float32": "fp32_fma", "bfloat16": "fp32_fma",
        "complex64": "fp32_fma", "complex128": "dmma",
        "float64:float32": "fp32_fma", "float64:float32+comp": "dmma",
        "float64:bfloat16": "bf16_mma", "float64:bfloat16+comp": "dmma",
        "float32:bfloat16": "bf16_mma", "float32:bfloat16+comp": "bf16_mma"}
