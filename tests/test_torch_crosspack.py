"""The port's crosspack path (dbcsr_tpu_torch.acc.crosspack, .crosspack_kernel,
.params and the driver choice of .smm) held against the JAX package on the
same numpy-seeded inputs, on the CPU.

On the CPU the port runs the plain PyTorch version of its CUDA crosspack
kernel, over the same pack layout the kernel walks; the JAX side runs the
Pallas crosspack kernels in interpret mode (f32/bf16, both variants), the
XLA stack driver (f64) and its own `prepare_stack` dispatch with `_on_tpu`
patched.  Tolerance: `kernel_validation_tolerance` of the dtype, the k depth
and the longest run, relative to max(|reference|, 1); f64 at <= 1e-12.
Tuned rows are written only under ``tmp_path``, through the two packages'
own directory variables.
"""

import itertools
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbcsr_tpu.acc import pallas_smm as jax_pallas
from dbcsr_tpu.acc import params as jax_params
from dbcsr_tpu.acc import smm as jax_smm
from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.mm.multiply import multiply as jax_multiply
from dbcsr_tpu.ops import test_methods as jax_tm

from dbcsr_tpu_torch.acc import crosspack, crosspack_kernel, params, stack_kernel
from dbcsr_tpu_torch.acc import smm as port_smm
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.mm.multiply import multiply as port_multiply
from dbcsr_tpu_torch.obs.costmodel import (
    crosspack_entries,
    kernel_validation_tolerance,
    stack_bound_s,
)
from dbcsr_tpu_torch.obs import metrics
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.perf.driver import parse_perf_file, run_perf
from dbcsr_tpu_torch.resilience import breaker, faults

INPUTS = os.path.join(os.path.dirname(__file__), "inputs")
ALPHA = 1.3


def _stack(seed, m, n, k, s=200, long_run=None):
    """f64 operands, a nonzero C and a sorted random stack; with
    ``long_run`` the stack is one run of that many entries into C block 1."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((30, m, k))
    b = rng.standard_normal((30, k, n))
    c = rng.standard_normal((22, m, n))
    if long_run:
        ci = np.full(long_run, 1, np.int32)
    else:
        ci = np.sort(rng.integers(0, 22, s)).astype(np.int32)
    ai = rng.integers(0, 30, len(ci)).astype(np.int32)
    bi = rng.integers(0, 30, len(ci)).astype(np.int32)
    return a, b, c, ai, bi, ci, int(np.bincount(ci).max())


def jax_state(m) -> dict:
    """The interop state of a JAX BlockSparseMatrix (bins sliced to count)."""
    return {
        "row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
        "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype),
        "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
        "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count]))
                 for b in m.bins],
    }


def _rel(got, want):
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1.0)


def _port_stack(a, b, c, ai, bi, ci, dtype, variant, pack=None):
    t = [torch.from_numpy(x).to(dtype) for x in (a, b, c)]
    out = port_smm.process_stack(t[2], t[0], t[1], ai, bi, ci, ALPHA,
                                 variant=variant, pack=pack)
    return (out.float() if dtype == torch.bfloat16 else out).numpy().astype(np.float64)


@pytest.fixture
def jax_config_restored():
    cfg = jax_get_config()
    prev = {"mm_driver": cfg.mm_driver, "validate_kernels": cfg.validate_kernels,
            "mm_format": cfg.mm_format, "incremental": cfg.incremental}
    yield
    jax_set_config(**prev)


@pytest.fixture
def port_config_restored():
    cfg = get_config()
    prev = {"mm_driver": cfg.mm_driver, "validate_kernels": cfg.validate_kernels}
    yield
    set_config(**prev)


@pytest.fixture(autouse=True)
def clean_resilience():
    """A failure a test provokes leaves no fault spec, open breaker,
    counter or demoted shape behind."""
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


# (block shape, forced pack) -- None: choose_pack's
PACK_CASES = [((23, 23, 23), None), ((8, 8, 8), None), ((64, 64, 64), None),
              ((16, 24, 12), (3, 5))]


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("mnk,pack", PACK_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crosspack_matches_pallas_kernel(dtype, mnk, pack, resident):
    m, n, k = mnk
    a, b, c, ai, bi, ci, depth = _stack(31, m, n, k)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    # both packages round the same float32 values to bf16 (nearest-even)
    a32, b32, c32 = (x.astype(np.float32) for x in (a, b, c))
    want = jax_pallas.process_stack_crosspack(
        jnp.asarray(c32, jdt), jnp.asarray(a32, jdt), jnp.asarray(b32, jdt),
        ai, bi, ci, ALPHA, pack=pack, vmem_resident=resident)
    assert want is not None
    got = _port_stack(a32, b32, c32, ai, bi, ci, tdt,
                      "crosspack_vmem" if resident else "crosspack", pack)
    assert _rel(got, np.asarray(want, np.float64)) <= kernel_validation_tolerance(dtype, k, depth)


@pytest.mark.parametrize("resident", [False, True])
def test_crosspack_long_run_single_c_block(resident):
    """One run holding every entry: one lane carries it, the others idle."""
    a, b, c, ai, bi, ci, depth = _stack(37, 16, 16, 16, long_run=200)
    a32, b32, c32 = (x.astype(np.float32) for x in (a, b, c))
    want = jax_pallas.process_stack_crosspack(
        jnp.asarray(c32), jnp.asarray(a32), jnp.asarray(b32), ai, bi, ci, ALPHA,
        vmem_resident=resident)
    got = _port_stack(a32, b32, c32, ai, bi, ci, torch.float32,
                      "crosspack_vmem" if resident else "crosspack")
    assert depth == 200
    assert _rel(got, np.asarray(want, np.float64)) <= kernel_validation_tolerance(
        "float32", 16, depth)


@pytest.mark.parametrize("variant", ["crosspack", "crosspack_vmem"])
@pytest.mark.parametrize("mnk,pack", [((23, 23, 23), None), ((5, 13, 23), None),
                                      ((16, 24, 12), (3, 5))])
def test_crosspack_f64_matches_xla_driver(mnk, pack, variant, jax_config_restored):
    m, n, k = mnk
    a, b, c, ai, bi, ci, depth = _stack(12, m, n, k)
    jax_set_config(mm_driver="xla")
    want = np.asarray(jax_smm.process_stack(jnp.asarray(c), jnp.asarray(a),
                                            jnp.asarray(b), ai, bi, ci, ALPHA))
    got = _port_stack(a, b, c, ai, bi, ci, torch.float64, variant, pack)
    assert _rel(got, want) <= 1e-12


def test_choose_pack_equals_jax():
    sizes = [4, 5, 7, 8, 9, 13, 16, 18, 23, 24, 32, 33, 45, 50, 64, 65, 80, 100]
    for m, n, k in itertools.product(sizes, repeat=3):
        assert crosspack.choose_pack(m, n, k) == jax_pallas.choose_pack(m, n, k)


@pytest.mark.parametrize("P,R", [(2, 2), (3, 5), (4, 4), (6, 2)])
def test_pack_layout_invariants(P, R):
    rng = np.random.default_rng(P * 10 + R)
    lens = rng.integers(1, 9, size=53)
    lens[[3, 40]] = (70, 25)
    ci = np.repeat(np.sort(rng.choice(200, size=53, replace=False)), lens)
    lay = crosspack.prepare_crosspack(ci, (P, R))
    run_len = np.diff(lay.run_ptr)
    assert np.array_equal(lay.run_c, np.unique(ci))
    assert lay.pack_runs.dtype == np.int32 and len(lay.pack_runs) == lay.npacks * P
    slots = lay.pack_runs
    # every run in exactly one slot; empty slots only at the end
    assert np.array_equal(np.sort(slots[slots >= 0]), np.arange(len(run_len)))
    assert np.all(slots[(slots >= 0).sum():] == -1)
    # the runs of each pack lie in one length class: no run of a later
    # pack is longer than any run of an earlier one
    packs = slots.reshape(-1, P)
    lo = [run_len[p[p >= 0]].min() for p in packs]
    hi = [run_len[p[p >= 0]].max() for p in packs]
    assert all(hi[i + 1] <= lo[i] for i in range(len(packs) - 1))
    assert np.array_equal(lay.pack_longest, hi)
    plan = port_smm.StackPlan()
    plan.pack, plan.pack_longest = (P, R), lay.pack_longest
    assert crosspack_entries(plan) == P * int(np.sum(hi)) >= len(ci)
    assert crosspack.prepare_crosspack(ci, (1, R)) is None


# ---------------------------------------------------------------- dispatch


@pytest.fixture
def tables(tmp_path, monkeypatch, jax_config_restored, port_config_restored):
    """Empty tuned tables of both packages under ``tmp_path``, a pretend
    accelerator on both sides, and a writer of the same rows to both."""
    monkeypatch.setenv("DBCSR_TPU_PARAMS_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("DBCSR_TPU_TORCH_PARAMS_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jax_smm, "_on_tpu", lambda: True)
    monkeypatch.setattr(port_smm, "_on_card", lambda c_data: True)

    def write(rows):
        for path in (jax_params.params_path(), params.params_path()):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump(rows, f)
        params.invalidate()
    return write


def _row(m, n, k, dtype="float32", variant="crosspack", pack_p=4, grouping=4, **kw):
    return {"m": m, "n": n, "k": k, "dtype": dtype, "driver": "pallas",
            "variant": variant, "grouping": grouping, "pack_p": pack_p,
            "gflops": 1.0, **kw}


def _operands(mnk, dtype, seed=41):
    m, n, k = mnk
    a, b, c, ai, bi, ci, _ = _stack(seed, m, n, k, s=120)
    return (a.astype(np.float32), b.astype(np.float32), c.astype(np.float32),
            ai, bi, ci)


def _decisions(mnk, dtype, driver):
    """(JAX decision, port decision), each (kernel, pack, resident) with
    kernel "crosspack" or "base"."""
    a, b, c, ai, bi, ci = _operands(mnk, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jax_set_config(mm_driver=driver, validate_kernels=False)
    jp = jax_smm.prepare_stack(jnp.asarray(c, jdt), jnp.asarray(a, jdt),
                               jnp.asarray(b, jdt), ai, bi, ci)
    set_config(mm_driver=driver, validate_kernels=False)
    t = [torch.from_numpy(x).to(tdt) for x in (a, b, c)]
    pp = port_smm.prepare_stack(t[2], t[0], t[1], ai, bi, ci)
    jd = (("crosspack", tuple(jp.pack), bool(jp.cross_vmem))
          if jp.driver == "pallas_cross" else ("base", None, False))
    pd = (("crosspack", pp.pack, pp.resident)
          if pp.driver == "crosspack" else ("base", None, False))
    return jd, pd


# the rules on which both packages make the same choice: (rows, shape,
# dtype, mm_driver, expected decision)
SHARED_RULES = {
    "auto_untuned_f32": ([], (23, 23, 23), "float32", "auto",
                         ("crosspack", (4, 4), False)),
    "forced_pallas_cross": ([], (23, 23, 23), "float32", "pallas_cross",
                            ("crosspack", (4, 4), False)),
    "forced_pallas": ([], (23, 23, 23), "float32", "pallas", ("base", None, False)),
    "p1_takes_base_kernel": ([], (100, 50, 20), "float32", "pallas_cross",
                             ("base", None, False)),
    "exact_row_pack": ([_row(12, 12, 12)], (12, 12, 12), "float32", "auto",
                       ("crosspack", (4, 4), False)),
    "exact_row_pack_clamped": ([_row(23, 23, 23, pack_p=8, grouping=8)], (23, 23, 23),
                               "float32", "auto", ("crosspack", (5, 5), False)),
    "predicted_donor_rederives_pack": ([_row(12, 12, 12, pack_p=8, grouping=8)],
                                       (23, 23, 23), "float32", "auto",
                                       ("crosspack", (4, 4), False)),
    "tuned_kmerge_row": ([_row(23, 23, 23, variant="kmerge", pack_p=None)], (23, 23, 23),
                         "float32", "auto", ("base", None, False)),
    "tuned_xla_row": ([dict(_row(23, 23, 23), driver="xla", variant=None)], (23, 23, 23),
                      "float32", "auto", ("base", None, False)),
    "exact_resident_row": ([_row(12, 12, 12, variant="crosspack_vmem")], (12, 12, 12),
                           "float32", "auto", ("crosspack", (4, 4), True)),
    "predicted_resident_donor": ([_row(12, 12, 12, variant="crosspack_vmem")],
                                 (13, 13, 13), "float32", "auto",
                                 ("crosspack", crosspack.choose_pack(13, 13, 13), True)),
    "bf16_exact_row": ([_row(12, 12, 12, dtype="bfloat16")], (12, 12, 12), "bfloat16",
                       "auto", ("crosspack", (4, 4), False)),
}


@pytest.mark.parametrize("rule", sorted(SHARED_RULES))
def test_dispatch_matches_jax(rule, tables):
    rows, mnk, dtype, driver, expected = SHARED_RULES[rule]
    tables(rows)
    jd, pd = _decisions(mnk, dtype, driver)
    assert jd == expected
    assert pd == expected


def _port_plan(mnk, dtype, driver="auto", seed=43):
    a, b, c, ai, bi, ci = _operands(mnk, "float32", seed)
    set_config(mm_driver=driver, validate_kernels=False)
    t = [torch.from_numpy(x).to(dtype) for x in (a, b, c)]
    return port_smm.prepare_stack(t[2], t[0], t[1], ai, bi, ci)


def test_auto_on_card_crosspacks_f32_and_bf16_but_not_f64(tables):
    tables([])
    assert _port_plan((23, 23, 23), torch.float32).driver == "crosspack"
    # the JAX package keeps untuned bf16 off crosspack for a TPU compiler
    # abort; the port drops that guard
    assert _port_plan((23, 23, 23), torch.bfloat16).driver == "crosspack"
    # f64 stays on the base kernel unless forced or tuned
    assert _port_plan((23, 23, 23), torch.float64).driver == "kernel"
    assert _port_plan((23, 23, 23), torch.float64, "pallas_cross").driver == "crosspack"
    # the same bf16 stack in the JAX package
    assert _decisions((23, 23, 23), "bfloat16", "auto")[0] == ("base", None, False)


def test_auto_on_cpu_tensor_takes_base_kernel(port_config_restored):
    assert _port_plan((23, 23, 23), torch.float32).driver == "kernel"
    assert _port_plan((23, 23, 23), torch.float32, "pallas_cross").driver == "crosspack"
    assert _port_plan((23, 23, 23), torch.float32, "torch").driver == "torch"


@pytest.mark.parametrize("limit,resident", [(10 ** 9, True), (1000, False)])
def test_resident_gate_reads_the_card_limit(limit, resident, tables, monkeypatch):
    tables([_row(12, 12, 12, variant="crosspack_vmem")])
    monkeypatch.setattr(crosspack, "resident_limit_bytes", lambda device: limit)
    plan = _port_plan((12, 12, 12), torch.float32)
    assert plan.driver == "crosspack" and plan.resident is resident
    assert plan.kernel == ("smm_crosspack_resident" if resident else "smm_crosspack")
    # the bin with fewer blocks (more re-reads per byte) takes the window
    assert plan.window == "a"


def test_port_reads_only_its_own_params_dir(tmp_path, monkeypatch):
    row = _row(23, 23, 23, variant="crosspack_vmem")
    monkeypatch.setenv("DBCSR_TPU_PARAMS_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("DBCSR_TPU_TORCH_PARAMS_DIR", str(tmp_path / "port"))
    jax_params.save_entry(dict(row))
    assert params.lookup(23, 23, 23, torch.float32) is None
    gen = params.generation()
    path = params.save_entry(dict(row, stack_size=5000))
    assert path == params.params_path() and str(tmp_path / "port") in path
    assert params.generation() > gen
    assert params.lookup(23, 23, 23, torch.float32)["variant"] == "crosspack_vmem"
    assert params.predict(23, 23, 23, "float32", stack_size=10)["stack_size"] == 5000
    assert params.delete_entry(23, 23, 23, torch.float32, 5000)
    assert not params.delete_entry(23, 23, 23, torch.float32, 5000)
    assert params.lookup(23, 23, 23, torch.float32) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert params.device_kind() == "cpu"


@pytest.mark.parametrize("query", [(23, 23, 23, 800), (13, 13, 13, 50), (23, 13, 5, None),
                                   (5, 13, 23, 100000), (64, 64, 64, 10), (100, 100, 100, 10)])
def test_predict_matches_jax(query, tmp_path, monkeypatch):
    monkeypatch.setenv("DBCSR_TPU_PARAMS_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("DBCSR_TPU_TORCH_PARAMS_DIR", str(tmp_path / "port"))
    rows = [_row(23, 23, 23, stack_size=30000), _row(23, 23, 23, stack_size=800000,
                                                     variant="kmerge"),
            _row(12, 12, 12, stack_size=1000), _row(5, 13, 23, stack_size=500),
            _row(13, 5, 23, stack_size=90000), _row(23, 13, 5, stack_size=20),
            _row(64, 64, 64, dtype="bfloat16")]
    for r in rows:
        jax_params.save_entry(dict(r))
        params.save_entry(dict(r))
    m, n, k, s = query
    want = jax_params.predict(m, n, k, np.float32, stack_size=s)
    got = params.predict(m, n, k, torch.float32, stack_size=s)
    if want is None:
        assert got is None
    else:
        want = {kk: (tuple(v) if isinstance(v, list) else v) for kk, v in want.items()}
        assert got == want


# ---------------------------------------------------- validation, failure


def test_first_use_validation_raises_on_corrupted_plain_version(monkeypatch,
                                                                port_config_restored):
    set_config(validate_kernels=True)
    a, b, c, ai, bi, ci, _ = _stack(16, 23, 23, 23)
    real = crosspack_kernel.smm_crosspack_plain

    def corrupted(c_data, *args, **kw):
        out = real(c_data, *args, **kw)
        out += 1.0
        return out

    monkeypatch.setattr(crosspack_kernel, "smm_crosspack_plain", corrupted)
    monkeypatch.setattr(port_smm, "_validated_kernels", set())
    t = [torch.from_numpy(x) for x in (a, b, c)]
    with pytest.raises(port_smm.KernelValidationError, match="smm_crosspack"):
        port_smm.process_stack(t[2], t[0], t[1], ai, bi, ci, ALPHA, variant="crosspack")


def test_first_use_validation_failure_raises_and_demotes_nothing(monkeypatch,
                                                                 port_config_restored):
    """A crosspack kernel proven wrong by its oracle reaches the caller
    with C as it was: it is counted and quarantined, nothing fails over,
    and the shape is not demoted (a numeric failure is no launch
    failure)."""
    set_config(validate_kernels=True)
    a, b, c, ai, bi, ci, _ = _stack(16, 23, 23, 23)
    real = crosspack_kernel.smm_crosspack_plain

    def corrupted(c_data, *args, **kw):
        out = real(c_data, *args, **kw)
        out += 1.0
        return out

    monkeypatch.setattr(crosspack_kernel, "smm_crosspack_plain", corrupted)
    monkeypatch.setattr(port_smm, "_validated_kernels", set())
    t = [torch.from_numpy(x) for x in (a, b, c)]
    got = t[2].clone()
    with pytest.raises(port_smm.KernelValidationError, match="smm_crosspack"):
        port_smm.process_stack(got, t[0], t[1], ai, bi, ci, ALPHA, variant="crosspack")
    assert torch.equal(got, t[2])
    assert metrics.counter_items("dbcsr_tpu_driver_failures_total") == [
        ({"driver": "pallas_cross", "kind": "validation"}, 1.0)]
    assert metrics.counter_items("dbcsr_tpu_driver_fallback_total") == []
    assert breaker.get_board().state("pallas_cross", (23, 23, 23, "float64")) == breaker.OPEN
    assert (23, 23, 23, "float64") not in port_smm._cross_disabled


def test_validation_keys_variant_and_pack(monkeypatch, port_config_restored):
    set_config(validate_kernels=True)
    a, b, c, ai, bi, ci, _ = _stack(17, 16, 24, 12)
    monkeypatch.setattr(port_smm, "_validated_kernels", set())
    t = [torch.from_numpy(x) for x in (a, b, c)]
    port_smm.process_stack(t[2], t[0], t[1], ai, bi, ci, ALPHA, variant="crosspack",
                           pack=(3, 5))
    port_smm.process_stack(t[2], t[0], t[1], ai, bi, ci, ALPHA, variant="crosspack_vmem")
    assert port_smm._validated_kernels == {
        (16, 24, 12, "float64", "cpu", "crosspack", (3, 5)),
        (16, 24, 12, "float64", "cpu", "crosspack_vmem", crosspack.choose_pack(16, 24, 12)),
    }


def test_failing_launch_raises_and_nothing_demotes(monkeypatch, port_config_restored):
    """An out-of-memory launch failure is transient: with every other
    driver of the chain failing too it reaches the caller, C is left as
    it was, and the shape is not demoted."""
    a, b, c, ai, bi, ci, _ = _stack(18, 23, 23, 23)

    def refuse(*args, **kw):
        raise RuntimeError("smm_crosspack launch failed: CUDA error 2: out of memory")

    monkeypatch.setattr(crosspack_kernel, "smm_crosspack", refuse)
    t = [torch.from_numpy(x) for x in (a, b, c)]
    c_before = t[2].clone()
    set_config(mm_driver="pallas_cross")
    for validate in (True, False):
        set_config(validate_kernels=validate)
        stack_kernel.reset_counts()
        with faults.inject_faults("pallas:raise;torch:raise;host:raise"):
            with pytest.raises(RuntimeError, match="launch failed"):
                port_smm.process_stack(t[2], t[0], t[1], ai, bi, ci, ALPHA)
        assert stack_kernel.launches == 0 and stack_kernel.plain_calls == 0
        assert torch.equal(t[2], c_before)
        breaker.reset_board()
    # the shape is not demoted: the next plan takes crosspack again
    assert port_smm.prepare_stack(t[2], t[0], t[1], ai, bi, ci).driver == "crosspack"
    assert metrics.counter_items("dbcsr_tpu_driver_fallback_total") == []


def test_failing_launch_fails_over_and_demotes(monkeypatch, port_config_restored):
    """A launch that fails with a runtime error fails over to the base
    kernel, is counted once, and demotes the shape: the next plan takes
    the base kernel (ref `dbcsr_tpu/acc/smm.py:1470-1505`)."""
    a, b, c, ai, bi, ci, _ = _stack(18, 23, 23, 23)

    def refuse(*args, **kw):
        raise RuntimeError("smm_crosspack launch failed: CUDA error 1")

    monkeypatch.setattr(crosspack_kernel, "smm_crosspack", refuse)
    t = [torch.from_numpy(x) for x in (a, b, c)]
    set_config(mm_driver="pallas_cross", validate_kernels=False)
    stack_kernel.reset_counts()
    got = port_smm.process_stack(t[2].clone(), t[0], t[1], ai, bi, ci, ALPHA)
    assert stack_kernel.plain_calls == 1  # K1's plain version on the CPU
    want = port_smm.process_stack(t[2].clone(), t[0], t[1], ai, bi, ci, ALPHA,
                                  variant="kmerge")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert metrics.counter_items("dbcsr_tpu_driver_failures_total") == [
        ({"driver": "pallas_cross", "kind": "runtime"}, 1.0)]
    assert metrics.counter_items("dbcsr_tpu_driver_fallback_total") == [
        ({"from": "pallas_cross", "to": "pallas"}, 1.0)]
    assert (23, 23, 23, "float64") in port_smm._cross_disabled
    assert port_smm.prepare_stack(t[2], t[0], t[1], ai, bi, ci).driver == "kernel"


def test_wrapper_rejects_bad_packs_and_devices():
    a, b, c, ai, bi, ci, _ = _stack(19, 64, 64, 64)
    t = [torch.from_numpy(x) for x in (a, b, c)]
    plan = port_smm.prepare_stack(t[2], t[0], t[1], ai, bi, ci, variant="crosspack")
    args = (plan.a_idx, plan.b_idx, plan.run_ptr, plan.run_c, plan.pack_runs)
    with pytest.raises(ValueError, match="outputs"):
        crosspack_kernel.smm_crosspack(t[2], t[0], t[1], *args, (4, 2))
    with pytest.raises(ValueError, match="P"):
        crosspack_kernel.smm_crosspack(t[2], t[0], t[1], *args, (1, 2))
    with pytest.raises(TypeError):
        crosspack_kernel.smm_crosspack(t[2], t[0].float(), t[1], *args, plan.pack)
    meta = [x.to("meta") for x in (t[2], t[0], t[1], *args)]
    crosspack_kernel.reset_counts()
    with pytest.raises(ValueError, match="no crosspack kernel"):
        crosspack_kernel.smm_crosspack(*meta, plan.pack)
    assert crosspack_kernel.plain_calls == 0 and crosspack_kernel.launches_cross == 0


def test_stack_bound_picks_the_larger_limit():
    t, by = stack_bound_s("float32", 23, 23, 23, 825573, 18900, 18900, 186045)
    assert by == "operations" and t == pytest.approx(2 * 23 ** 3 * 825573 / 67e12)
    t, by = stack_bound_s("float64", 23, 23, 23, 825573, 18900, 18900, 186045)
    assert by == "bytes" and 4e-4 < t < 6e-4


# ------------------------------------------------------------- the slice


@pytest.mark.parametrize("blocking", ["uniform", "mixed"])
def test_multiply_pallas_cross_matches_jax(blocking, jax_config_restored,
                                           port_config_restored):
    # mixed: 5/13/23 row blocks and 13/23 column blocks over 23-deep inner
    # blocks (six shape triples, each its own interpret-mode kernel on the
    # JAX side)
    rows = np.full(4, 23) if blocking == "uniform" else np.array([5, 13, 23, 13])
    cols = np.full(3, 23) if blocking == "uniform" else np.array([23, 13, 23])
    inner = np.full(3, 23)
    rng = np.random.default_rng(2026)

    def pair(name, rows, cols, occ):
        jm = jax_tm.make_random_matrix(name, rows, cols, dtype=np.float32,
                                       occupation=occ, rng=rng)
        return jm, matrix_from_numpy_state(jax_state(jm), "cpu", name=name)

    ja, pa = pair("A", rows, inner, 0.6)
    jb, pb = pair("B", inner, cols, 0.6)
    jc, pc = pair("C", rows, cols, 0.3)
    # the JAX side's first-use validation would run each interpret-mode
    # kernel twice; the port's stays on
    jax_set_config(mm_format="stack", incremental="off", mm_driver="pallas_cross",
                   validate_kernels=False)
    set_config(mm_driver="pallas_cross", validate_kernels=True)
    jflops = jax_multiply("N", "N", 0.7, ja, jb, 0.5, jc)
    pflops = port_multiply("N", "N", 0.7, pa, pb, 0.5, pc)
    assert pflops == jflops
    assert np.array_equal(pc.keys, jc.keys)
    assert {s[4] for s in pc._mm_spans} == {"smm_crosspack"}
    want = jax_tm.to_dense(jc).astype(np.float64)
    got = port_tm.to_dense(pc).astype(np.float64)
    tol = kernel_validation_tolerance("float32", 23, len(inner))
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("name", ["test_square_sparse", "test_rect2_sparse"])
def test_run_perf_pallas_cross_reproduces_committed_checksums(name, port_config_restored):
    cfg = parse_perf_file(os.path.join(INPUTS, f"{name}.perf"))
    cfg.nrep = 1
    set_config(mm_driver="pallas_cross")
    res = run_perf(cfg, verbose=False, device="cpu")  # raises on mismatch
    assert {s[4] for s in res["spans"]} == {"smm_crosspack"}
    assert res["launches"]["smm_stack"] == 0
    assert res["launches"]["plain"] > 0  # the CPU runs the plain version
