"""The port's acc micro-benchmarks and tuner (dbcsr_tpu_torch.acc.bench,
dbcsr_tpu_torch.acc.tune) and its parameter table, held against the JAX
package on the CPU.

The cases of `tests/test_acc_bench_tune.py`, its slow `tune_smm` case
here at a stack of a few hundred entries, plus:

* `bench_smm` validates within the JAX package's tolerance (2e-2 bf16,
  1e-3 f32, 1e-10 f64) in both packages on seed 42, and
  `transpose_blocks` equals the JAX package's;
* a row the port's tuner writes reads back through the JAX package's
  loader, and the JAX package's TPU table through the port's;
* the CPU candidate set holds the plain version and the host driver; a
  candidate set for the card holds the hand-written kernels only, and
  refuses P <= 1 packs and an unadmitted K4 with a reason;
* a candidate that raises or fails its check against the plain version
  is reported in ``errors``, never skipped in silence.

Every test writes tables under ``tmp_path`` only.
"""

import json
import os

import numpy as np
import pytest
import torch

from dbcsr_tpu.acc import params as jax_params
from dbcsr_tpu.acc.bench import bench_smm as jax_bench_smm
from dbcsr_tpu.acc.smm import transpose_blocks as jax_transpose_blocks

from dbcsr_tpu_torch.acc import bench, params, stack_kernel, tune
from dbcsr_tpu_torch.acc.bench import bench_smm, bench_trans
from dbcsr_tpu_torch.acc.smm import transpose_blocks
from dbcsr_tpu_torch.acc.tune import candidate_set, table_rows, tune_smm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = {"smm_stack", "smm_crosspack", "smm_crosspack_resident"}
BENCH_TOL = {1: 1e-3, 3: 1e-10, 9: 2e-2}


@pytest.fixture(autouse=True)
def tables(monkeypatch, tmp_path):
    monkeypatch.setenv("DBCSR_TPU_TORCH_PARAMS_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("DBCSR_TPU_PARAMS_DIR", str(tmp_path / "jax"))
    params.invalidate()
    jax_params.invalidate()
    yield
    params.invalidate()
    jax_params.invalidate()


def quiet(*_):
    pass


# ------------------------------------------------------------ benchmarks
@pytest.mark.parametrize("dtype_enum", [3, 1, 9])
def test_bench_smm_validates(dtype_enum):
    res = bench_smm(nrep=1, stack_size=300, m=5, n=4, k=6, dtype_enum=dtype_enum, out=quiet,
                    device="cpu")
    assert res["errors"] == 0 and res["max_rel_err"] < BENCH_TOL[dtype_enum]
    assert res["gflops"] > 0 and res["device_kind"] == "cpu" and res["timed"] == "execute"
    assert res["driver"] == "pallas" and res["launched"] == "smm_stack"
    assert res["min_bytes"] < res["bytes"]


@pytest.mark.parametrize("dtype_enum", [3, 1])
def test_bench_smm_error_within_the_jax_tolerance(dtype_enum):
    """Seed 42 in both packages: the same operands (the same draws), each
    product within the JAX package's tolerance, and the port's result
    carries every key of the JAX package's."""
    port = bench_smm(nrep=1, stack_size=400, m=7, n=5, k=9, dtype_enum=dtype_enum, out=quiet,
                     seed=42, device="cpu")
    ref = jax_bench_smm(nrep=1, stack_size=400, m=7, n=5, k=9, dtype_enum=dtype_enum,
                        out=quiet, seed=42)
    for res in (port, ref):
        assert res["errors"] == 0 and res["max_rel_err"] < BENCH_TOL[dtype_enum]
    assert set(ref) - {"device"} <= set(port)
    assert port["stack_size"] == ref["stack_size"] and port["dtype"] == ref["dtype"]
    # the JAX package's byte convention, on the same stack
    assert port["bytes"] == pytest.approx(ref["gbs"] * ref["ms"] * 1e6, rel=1e-9)


def test_bench_trans_validates():
    res = bench_trans(nrep=1, stack_size=300, m=5, n=7, out=quiet, device="cpu")
    assert res["errors"] == 0 and res["bytes"] == 2 * 75 * 5 * 7 * 8


def test_transpose_blocks_matches_jax():
    x = np.random.default_rng(3).standard_normal((6, 5, 7))
    got = transpose_blocks(torch.from_numpy(x))
    assert got.is_contiguous() and got.shape == (6, 7, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_transpose_blocks(x)))


def test_bench_cli_refuses_bad_mode(capsys):
    assert bench.main(["bogus"]) == 1
    assert "python -m dbcsr_tpu_torch.acc.bench" in capsys.readouterr().out
    assert tune.main([]) == 1


def test_host_oracle_matches_a_loop():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((9, 3, 4))
    b = rng.standard_normal((8, 4, 2))
    ai, bi = rng.integers(0, 9, 50), rng.integers(0, 8, 50)
    ci = np.sort(rng.integers(0, 6, 50))
    want = np.zeros((6, 3, 2))
    for x, y, z in zip(ai, bi, ci):
        want[z] += a[x] @ b[y]
    got = bench.host_oracle(torch.from_numpy(a), torch.from_numpy(b), ai, bi, ci, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-14)


# ----------------------------------------------------------- the table
def test_params_roundtrip():
    assert params.lookup(3, 3, 3, torch.float32) is None
    params.save_entry({"m": 3, "n": 3, "k": 3, "dtype": "float32", "driver": "pallas",
                       "grouping": 4, "gflops": 1.0})
    params.invalidate()
    got = params.lookup(3, 3, 3, torch.float32)
    assert got is not None and got["grouping"] == 4


def test_predict_falls_back_to_nearest_tuned_entry():
    params.save_entry({"m": 5, "n": 5, "k": 5, "dtype": "float64", "driver": "pallas",
                       "grouping": None, "gflops": 10.0})
    params.save_entry({"m": 32, "n": 32, "k": 32, "dtype": "float64", "driver": "pallas",
                       "variant": "crosspack", "grouping": 2, "pack_p": 2, "gflops": 99.0})
    assert "predicted_from" not in params.predict(5, 5, 5, "float64")
    p = params.predict(30, 30, 30, "float64")
    assert p["variant"] == "crosspack" and p["predicted_from"] == (32, 32, 32)
    assert params.predict(8, 8, 8, "float32") is None


def test_params_stack_size_rows_coexist():
    base = {"m": 23, "n": 23, "k": 23, "dtype": "float64", "grouping": None, "gflops": 1.0}
    params.save_entry({**base, "stack_size": 30000, "driver": "pallas"})
    params.save_entry({**base, "stack_size": 800000, "driver": "pallas",
                       "variant": "crosspack", "pack_p": 5, "grouping": 5})
    with open(params.params_path()) as fh:
        assert len(json.load(fh)) == 2
    assert params.lookup(23, 23, 23, "float64", 20000).get("variant") is None
    assert params.lookup(23, 23, 23, "float64", 900000)["variant"] == "crosspack"
    assert params.lookup(23, 23, 23, "float64")["stack_size"] == 800000
    p_small = params.predict(21, 21, 21, "float64", stack_size=30000)
    p_big = params.predict(21, 21, 21, "float64", stack_size=700000)
    assert p_small.get("variant") is None and p_big["variant"] == "crosspack"
    assert p_big["predicted_from"] == (23, 23, 23)


def test_jax_tpu_table_reads_in_the_port(monkeypatch):
    """The JAX package's committed TPU table through the port's loader:
    every row comes back as written, keyed the same way."""
    src = os.path.join(ROOT, "dbcsr_tpu", "acc", "params")
    monkeypatch.setenv("DBCSR_TPU_TORCH_PARAMS_DIR", src)
    monkeypatch.setattr(params, "device_kind", lambda: "TPU_v5_lite")
    params.invalidate()
    with open(os.path.join(src, "parameters_TPU_v5_lite.json")) as fh:
        rows = json.load(fh)
    assert rows
    for row in rows:
        got = params.lookup(row["m"], row["n"], row["k"], row["dtype"], row["stack_size"])
        assert got == row


# ------------------------------------------------------------- the tuner
def test_tune_smm_writes_entry():
    entry = tune_smm(4, 4, 4, dtype_enum=1, stack_size=200, nrep=1, out=quiet, device="cpu")
    assert entry["errors"] == 0 and entry["env"] == "cpu"
    assert entry["driver"] in ("pallas", "torch", "host")
    params.invalidate()
    got = params.lookup(4, 4, 4, torch.float32)
    # the rate is the CPU's (rounded to 0.01 GFLOP/s, as the JAX package
    # rounds it): only that the returned row is the one persisted
    assert got is not None and got["gflops"] == entry["gflops"] >= 0
    assert "errors" not in got and got["kernel"] == entry["kernel"]


def test_tuned_row_reads_back_in_jax(monkeypatch, tmp_path):
    """A row of the port's tuner, in the device kind's file, through the
    JAX package's loader (both key a CPU table "cpu")."""
    shared = str(tmp_path / "shared")
    monkeypatch.setenv("DBCSR_TPU_TORCH_PARAMS_DIR", shared)
    monkeypatch.setenv("DBCSR_TPU_PARAMS_DIR", shared)
    params.invalidate()
    jax_params.invalidate()
    cands = []
    entry = tune_smm(5, 13, 23, dtype_enum=3, stack_size=300, nrep=1, out=quiet,
                     device="cpu", candidates_out=cands)
    assert os.path.basename(params.params_path()) == os.path.basename(jax_params.params_path())
    got = jax_params.lookup(5, 13, 23, np.float64, 300)
    assert got is not None
    assert {k: got[k] for k in ("driver", "grouping", "gflops", "stack_size", "env")} == \
        {k: entry[k] for k in ("driver", "grouping", "gflops", "stack_size", "env")}
    # every candidate was checked against the plain version
    assert cands and all(c["max_rel_err"] <= c["tol"] for c in cands)


def test_tune_persist_false_writes_nothing():
    cands = []
    entry = tune_smm(4, 4, 4, dtype_enum=3, stack_size=100, nrep=1, out=quiet, device="cpu",
                     persist=False, candidates_out=cands)
    assert entry["errors"] == 0 and len(cands) >= 4
    assert not os.path.exists(params.params_path())


def test_cpu_candidates_include_the_plain_version_and_the_host_driver():
    cands, _ = candidate_set(23, 23, 23, torch.float64, on_card=False, resident=True)
    tags = [t for t, _, _ in cands]
    assert tags[:2] == ["torch", "host"]
    assert {"K1", "K1 f32c", "K1 f32"} <= set(tags)
    assert any(t.startswith("K3") for t in tags) and any(t.startswith("K4") for t in tags)
    bf16, _ = candidate_set(23, 23, 23, torch.bfloat16, on_card=False, resident=True)
    assert "host" not in [t for t, _, _ in bf16]  # the host driver takes no bf16


@pytest.mark.parametrize("shape", [(23, 23, 23), (5, 13, 23), (4, 4, 4), (64, 64, 64),
                                   (529, 23, 23)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_card_candidates_are_the_kernels_only(shape, dtype):
    """Forced for the card: no plain version, no host driver, every row a
    kernel's; every pack within dispatch's clamp; refusals say why."""
    m, n, k = shape
    for resident in (True, False):
        cands, refused = candidate_set(m, n, k, dtype, on_card=True, resident=resident)
        assert cands
        for tag, row, how in cands:
            assert row["driver"] == "pallas" and how["kernel"] in KERNELS
            assert how.get("driver") is None
            if how.get("pack"):
                P, R = how["pack"]
                assert 2 <= P <= max(1, min(8, 128 // max(m, n)))
                assert 1 <= R <= max(1, min(8, 128 // k))
        kernels = {how["kernel"] for _, _, how in cands}
        if not resident:
            assert "smm_crosspack_resident" not in kernels
            assert all("persisting-L2" in why for t, why in refused if t.startswith("K4"))
    if max(m, n) > 64:  # P <= 1: K1 only
        assert kernels == {"smm_stack"}
        assert any("P <= 1" in why for _, why in refused)


def test_failing_candidates_are_reported(monkeypatch):
    """A kernel that raises and a kernel whose output is off: both named
    in ``failures`` and counted in ``errors``; the rest still tuned."""
    from dbcsr_tpu_torch.acc import crosspack_kernel

    def broken(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(crosspack_kernel, "smm_crosspack", broken)
    real = stack_kernel.smm_stack

    def off(c, *args, precision=None, **kwargs):
        out = real(c, *args, precision=precision, **kwargs)
        if precision is not None:
            out.add_(1.0)
        return out

    monkeypatch.setattr(stack_kernel, "smm_stack", off)
    lines = []
    entry = tune_smm(5, 5, 5, dtype_enum=3, stack_size=200, nrep=1, out=lines.append,
                     device="cpu")
    failed = {f["candidate"] for f in entry["failures"]}
    assert entry["errors"] == len(failed) > 0
    assert {"K1 f32c", "K1 f32"} <= failed
    assert {t for t in failed if t.startswith(("K3", "K4"))}
    assert any("failed (RuntimeError: launch failed)" in ln for ln in lines)
    assert entry["kernel"] in ("plain", "host_smm", "smm_stack")


def test_table_rows_cover_the_workloads():
    rows = table_rows()
    keys = {(m, n, k, dt) for m, n, k, dt, _ in rows}
    for dt in (3, 1):
        for mnk in [(23, 23, 23), (529, 23, 23), (4, 4, 4), (32, 32, 32), (64, 64, 64),
                    (5, 13, 21), (21, 21, 21), (18, 23, 18)]:
            assert (*mnk, dt) in keys
        assert (23, 23, 23, dt, tune.NORTHSTAR_SPAN) in rows
    assert (23, 23, 23, 9, 30000) in rows
    assert len(rows) == len(set(rows))
