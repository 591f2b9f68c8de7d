"""K1's tiled complex and demoted forms on the tensor layer, held against
the JAX package on the CPU.

The 3-center contraction T(i,j,k) M(k,l) -> C(i,j,l) with (i,j) mapped
to the rows, as the RI contraction maps it (`chip_smoke.py`'s `tensor`
phases): the mapped row blocks join an i and a j block, over 32 rows,
so on the card every stack of the contraction takes K1's tiled path.
Here the same operands, made from a numpy seed, go through both
packages' `tensor.contract` (the port's stacks on the kernel wrapper's
plain version, the JAX package's on its XLA stack driver):

* complex128 and complex64 (complex operands and alpha), within
  `kernel_validation_tolerance`;
* float64 under ``precision="adaptive"`` and ``abft="verify"`` in both
  packages: the same stacks demote to f32 (the same cells and demoted
  launch counts), every probe passes, and C agrees within the demoted
  form's `form_tolerance`.
"""

import itertools

import numpy as np
import pytest
import torch

from dbcsr_tpu.acc import abft as jax_abft
from dbcsr_tpu.acc import precision as jax_precision
from dbcsr_tpu.core.config import get_config as jax_get_config
from dbcsr_tpu.core.config import set_config as jax_set_config
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.obs import events as jax_events
from dbcsr_tpu.obs import health as jax_health
from dbcsr_tpu.obs import metrics as jax_metrics
from dbcsr_tpu.obs import timeseries as jax_timeseries
from dbcsr_tpu.resilience import breaker as jax_breaker
from dbcsr_tpu.tensor import contract as jax_contract
from dbcsr_tpu.tensor import create_tensor as jax_create_tensor

from dbcsr_tpu_torch.acc import abft, precision
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.interop import tensor_from_numpy_state
from dbcsr_tpu_torch.mm import multiply as port_mm
from dbcsr_tpu_torch.obs import costmodel, events, metrics
from dbcsr_tpu_torch.resilience import breaker
from dbcsr_tpu_torch.tensor import contract, create_tensor

_JAX_CFG = ("precision", "abft", "mm_driver", "mm_format", "incremental", "platform_override")
_PORT_CFG = ("precision", "abft", "mm_driver", "mm_format", "incremental")
# T(i,j,k) and M(k,l): i blocks of 2 and 3, j of 17 and 20 (mapped row
# blocks of 34 to 60 rows), k of 4 and 2, l of 2 and 3
SIZES = {"i": [2, 3], "j": [17, 20], "k": [4, 2], "l": [2, 3]}
KW = dict(contract_a=(2,), notcontract_a=(0, 1), contract_b=(0,), notcontract_b=(1,),
          map_1=(0, 1), map_2=(2,))


@pytest.fixture(autouse=True)
def clean(monkeypatch, tmp_path):
    """Both packages on the stack format with empty parameter tables (a
    tuned row would outrank adaptive demotion) and the JAX package on its
    XLA driver as a CPU platform; afterwards both packages' precision
    cells, probes, breakers and configs, the port's metrics and events,
    and the JAX package's metrics, health model, events and telemetry
    store are reset, so a later file in the same worker starts from a
    healthy JAX plane."""
    monkeypatch.setenv("DBCSR_TPU_PARAMS_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("DBCSR_TPU_TORCH_PARAMS_DIR", str(tmp_path / "port"))
    jcfg = {k: getattr(jax_get_config(), k) for k in _JAX_CFG}
    pcfg = {k: getattr(get_config(), k) for k in _PORT_CFG}
    jax_set_config(platform_override="cpu", mm_driver="xla", mm_format="stack",
                   incremental="off")
    set_config(mm_format="stack", incremental="off")
    for mod in (precision, jax_precision):
        mod.reset()
    yield
    for mod in (precision, jax_precision):
        mod.reset()
    abft.discard_pending()
    jax_abft.discard_pending()
    breaker.reset_board()
    jax_breaker.reset_board()
    metrics.reset()
    events.clear()
    port_mm.clear_plan_cache()
    for reset in (jax_metrics.reset, jax_health.reset, jax_events.clear, jax_timeseries.reset):
        reset()
    jax_set_config(**jcfg)
    set_config(**pcfg)


def _values(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _rand(name, blk_sizes, occ, seed, dtype, row_dims=None, col_dims=None):
    """(JAX, port) tensors with the same blocks (complex: both parts
    drawn), the port's carried over by the interop state."""
    rng = np.random.default_rng(seed)
    t = jax_create_tensor(name, blk_sizes, row_dims, col_dims, dtype=dtype)
    for idx in itertools.product(*(range(len(n)) for n in blk_sizes)):
        if rng.random() < occ:
            t.put_block(idx, _values(rng, t.block_shape(idx), dtype))
    t.finalize()
    state = {"blk_sizes": t.blk_sizes, "row_dims": t.row_dims, "col_dims": t.col_dims,
             "dtype": jax_enum_of(t.dtype), "indices": t.entry_multi_coords(),
             "blocks": [blk for _, blk in t.iterate_blocks()]}
    return t, tensor_from_numpy_state(state, "cpu", name=name)


def _contract_both(dtype, alpha, seed):
    """T M -> C in both packages: (port C, JAX C, their dense results)."""
    s = SIZES
    jt, pt = _rand("t", [s["i"], s["j"], s["k"]], 0.8, seed, dtype, (0, 1), (2,))
    jm, pm = _rand("m", [s["k"], s["l"]], 0.9, seed + 1, dtype)
    jc = jax_create_tensor("c", [s["i"], s["j"], s["l"]], (0, 1), (2,), dtype=dtype).finalize()
    pc = create_tensor("c", [s["i"], s["j"], s["l"]], (0, 1), (2,), dtype=dtype,
                       device="cpu").finalize()
    jf = jax_contract(alpha, jt, jm, 0.0, jc, **KW)
    pf = contract(alpha, pt, pm, 0.0, pc, **KW)
    assert pf == jf
    assert int(pc.matrix.row_blk_sizes.min()) > 32, "the mapped rows must exceed the warp path"
    return pc, jc, pc.to_dense(), np.asarray(jc.to_dense())


def _rel(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1.0)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_contract_rank3_complex_against_jax(dtype):
    """The 3-center contraction in complex data with a complex alpha: the
    port's C holds the JAX package's block pattern and values within
    `kernel_validation_tolerance` (at k = 6 and 2 entries a run)."""
    pc, jc, got, want = _contract_both(dtype, 0.75 - 0.5j, seed=41)
    assert pc.dtype == (torch.complex128 if dtype == np.complex128 else torch.complex64)
    assert sorted(map(tuple, pc.block_indices())) == sorted(map(tuple, jc.block_indices()))
    name = np.dtype(dtype).name
    tol = costmodel.kernel_validation_tolerance(name, sum(SIZES["k"]), len(SIZES["k"]))
    assert np.abs(want).max() > 0 and np.abs(want.imag).max() > 0
    assert _rel(got, want) <= tol


def test_contract_rank3_adaptive_precision_against_jax():
    """The 3-center contraction in f64 under ``precision="adaptive"`` and
    ``abft="verify"`` in both packages: every stack demotes to f32 in
    both (the same cells, each demoted and certified, and as many f64 ->
    f32 launches), no probe fails, and C agrees within the f64 -> f32
    form's `form_tolerance`."""
    set_config(precision="adaptive", abft="verify")
    jax_set_config(precision="adaptive", abft="verify")
    pc, jc, got, want = _contract_both(np.float64, 1.0, seed=43)
    cells, jcells = precision.cells_snapshot(), jax_precision.cells_snapshot()
    assert cells and set(cells) == set(jcells)
    assert all(cells[c]["state"] == jcells[c]["state"] == "demoted" for c in cells)
    assert all(max(c[:2]) > 32 for c in cells)
    launched = metrics.counter_items("dbcsr_tpu_precision_launches_total")
    assert launched == jax_metrics.counter_items("dbcsr_tpu_precision_launches_total")
    assert [lab for lab, _ in launched] == [
        {"requested": "float64", "compute": "float32", "compensated": "false"}]
    for reg in (metrics, jax_metrics):
        assert not reg.counter_items("dbcsr_tpu_abft_mismatches_total")
        assert not reg.counter_items("dbcsr_tpu_precision_promotions_total")
    tol = costmodel.form_tolerance("float64", ("float32", False), sum(SIZES["k"]),
                                   len(SIZES["k"]))
    assert _rel(got, want) <= tol
