"""The port's CSR conversions (dbcsr_tpu_torch.ops.csr) and binary I/O
(dbcsr_tpu_torch.ops.io) held against the JAX package on the CPU.

The cases of `tests/test_csr_io.py` but the mesh one (it is in
`tests/test_torch_parallel.py`), on operands drawn by the JAX
package from one numpy seed and carried across, plus:

* `csr_from_matrix` gives the JAX package's arrays exactly, and
  `matrix_from_csr` its matrix, with the native COO fill and with the
  NumPy path (``DBCSR_TPU_TORCH_NATIVE=0``), each counted;
* a binary file written by either package reads back bit for bit in
  the other, and the two packages write the same bytes, for real and
  complex kinds and every symmetry;
* a damaged file is refused.

Values agree bit for bit (the conversions only move elements).
"""

import io

import numpy as np
import pytest
import torch

import dbcsr_tpu as jdt
from dbcsr_tpu.core.kinds import enum_of as jax_enum_of
from dbcsr_tpu.ops import csr as jax_csr
from dbcsr_tpu.ops import io as jax_io

import dbcsr_tpu_torch as pdt
from dbcsr_tpu_torch import native
from dbcsr_tpu_torch.interop import matrix_from_numpy_state
from dbcsr_tpu_torch.mm import multiply as port_mm
from dbcsr_tpu_torch.ops import csr as port_csr
from dbcsr_tpu_torch.ops import io as port_io


def jax_state(m) -> dict:
    return {"row_blk_sizes": m.row_blk_sizes, "col_blk_sizes": m.col_blk_sizes,
            "matrix_type": m.matrix_type, "dtype": jax_enum_of(m.dtype),
            "keys": m.keys, "ent_bin": m.ent_bin, "ent_slot": m.ent_slot,
            "bins": [(b.shape[0], b.shape[1], np.asarray(b.data[: b.count])) for b in m.bins]}


def pair(seed, rows, cols, occ=0.5, dtype=np.float64, kind="N"):
    jm = jdt.make_random_matrix("m", rows, cols, dtype=dtype, occupation=occ,
                                matrix_type=kind, rng=np.random.default_rng(seed))
    return jm, matrix_from_numpy_state(jax_state(jm), "cpu", name="m")


def same_bits(pm, jm) -> bool:
    """The port's matrix holds the JAX package's index and values, bit for
    bit."""
    if not (np.array_equal(pm.keys, jm.keys) and np.array_equal(pm.ent_bin, jm.ent_bin)
            and np.array_equal(pm.ent_slot, jm.ent_slot)):
        return False
    return all(np.array_equal(pb.data.numpy(), np.asarray(jb.data[: jb.count]))
               for pb, jb in zip(pm.bins, jm.bins))


# -------------------------------------------------------------- CSR
@pytest.mark.parametrize("engine", ["1", "0"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
def test_csr_roundtrip(monkeypatch, engine, dtype):
    monkeypatch.setenv("DBCSR_TPU_TORCH_NATIVE", engine)
    jm, pm = pair(0, [2, 3, 4], [3, 2, 2], dtype=dtype)
    indptr, indices, data = port_csr.csr_from_matrix(pm)
    for got, want in zip((indptr, indices, data), jax_csr.csr_from_matrix(jm)):
        np.testing.assert_array_equal(got, want)
    assert len(indptr) == pm.nfullrows + 1 and indptr[-1] == len(indices) == len(data)
    dense = np.zeros((pm.nfullrows, pm.nfullcols), data.dtype)
    for r in range(pm.nfullrows):
        dense[r, indices[indptr[r]: indptr[r + 1]]] = data[indptr[r]: indptr[r + 1]]
    np.testing.assert_array_equal(dense, pdt.to_dense(pm))
    port_mm.reset_totals()
    back = port_csr.matrix_from_csr("m2", indptr, indices, data, pm.row_blk_sizes,
                                    pm.col_blk_sizes, device="cpu")
    kind = "native" if engine == "1" else "numpy"
    assert port_mm.read_totals()["index_engine"]["coo_fill"][kind] == 1
    assert same_bits(back, jax_csr.matrix_from_csr("m2", indptr, indices, data,
                                                   jm.row_blk_sizes, jm.col_blk_sizes))


def test_csr_from_symmetric():
    jm, pm = pair(1, [2, 3], [2, 3], occ=1.0, kind="S")
    indptr, indices, data = port_csr.csr_from_matrix(pm)
    for got, want in zip((indptr, indices, data), jax_csr.csr_from_matrix(jm)):
        np.testing.assert_array_equal(got, want)
    dense = np.zeros((5, 5))
    for r in range(5):
        dense[r, indices[indptr[r]: indptr[r + 1]]] = data[indptr[r]: indptr[r + 1]]
    np.testing.assert_array_equal(dense, pdt.to_dense(pm))


def test_csr_keep_zeros_and_duplicates():
    """Zeros inside stored blocks only with ``keep_zeros``; a duplicate
    element of a non-canonical CSR input resolves last-wins in both
    engines and in the JAX package."""
    m = pdt.create("z", [2], [2], device="cpu")
    m.put_block(0, 0, np.array([[1.0, 0.0], [0.0, 2.0]]))
    m.finalize()
    assert len(port_csr.csr_from_matrix(m)[2]) == 2
    assert len(port_csr.csr_from_matrix(m, keep_zeros=True)[2]) == 4
    indptr, indices, data = [0, 2, 3], [1, 1, 0], np.array([5.0, 7.0, 3.0])
    want = jdt.to_dense(jax_csr.matrix_from_csr("d", np.array(indptr), np.array(indices),
                                                data, [2], [2]))
    for engine in ("1", "0"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DBCSR_TPU_TORCH_NATIVE", engine)
            got = port_csr.matrix_from_csr("d", np.array(indptr), np.array(indices), data,
                                           [2], [2], device="cpu")
        np.testing.assert_array_equal(pdt.to_dense(got), want)
        assert pdt.to_dense(got)[0, 1] == 7.0


def test_matrix_from_csr_rejects_bad_input():
    with pytest.raises(ValueError, match="indptr"):
        port_csr.matrix_from_csr("x", [0, 1], [0], np.ones(1), [2], [2], device="cpu")
    with pytest.raises(ValueError, match="column"):
        port_csr.matrix_from_csr("x", [0, 1, 1], [5], np.ones(1), [2], [2], device="cpu")
    with pytest.raises(ValueError, match="length"):
        port_csr.matrix_from_csr("x", [0, 2, 2], [0], np.ones(1), [2], [2], device="cpu")


def test_coo_fill_blocks_checks_positions():
    out = np.zeros(4)
    native.coo_fill_blocks([0, 0], [0, 1], [1, 0], np.array([1.0, 2.0]), [0], [2], out)
    np.testing.assert_array_equal(out, [0.0, 1.0, 2.0, 0.0])
    with pytest.raises(IndexError):
        native.coo_fill_blocks([0], [2], [0], np.array([1.0]), [0], [2], out)
    with pytest.raises(IndexError):
        native.coo_fill_blocks([1], [0], [0], np.array([1.0]), [0], [2], out)
    with pytest.raises(ValueError):
        native.coo_fill_blocks([0], [0], [0], np.array([1.0], np.float32), [0], [2], out)


@pytest.mark.parametrize("kind", ["N", "S"])
def test_complete_redistribute_reblocking(kind):
    rows = [3, 4, 2]
    cols = [2, 5] if kind == "N" else [3, 4, 2]
    jm, pm = pair(2, rows, cols, occ=0.7, kind=kind)
    new_r, new_c = [2, 2, 5], ([4, 3] if kind == "N" else [1, 6, 2])
    m2 = port_csr.complete_redistribute(pm, new_r, new_c)
    j2 = jax_csr.complete_redistribute(jm, new_r, new_c)
    assert same_bits(m2, j2)
    np.testing.assert_array_equal(pdt.to_dense(m2), pdt.to_dense(pm))
    m3 = port_csr.complete_redistribute(m2, rows, cols)
    np.testing.assert_array_equal(pdt.to_dense(m3), pdt.to_dense(pm))


def test_complete_redistribute_rejects_bad_blocking():
    _, pm = pair(3, [2, 2], [2, 2], occ=1.0)
    with pytest.raises(ValueError):
        port_csr.complete_redistribute(pm, [3, 3], [2, 2])


# -------------------------------------------------------------- binary I/O
CASES = [(np.float64, "N"), (np.float32, "N"), (np.complex128, "N"), (np.complex64, "N"),
         (np.float64, "S"), (np.float64, "A"), (np.complex128, "H")]


@pytest.mark.parametrize("dtype,kind", CASES)
def test_binary_roundtrip_across_packages(tmp_path, dtype, kind):
    jm, pm = pair(4, [2, 3, 4], [2, 3, 4], occ=0.6, dtype=dtype, kind=kind)
    port_path, jax_path = str(tmp_path / "port.dbcsr"), str(tmp_path / "jax.dbcsr")
    port_io.binary_write(pm, port_path)
    jax_io.binary_write(jm, jax_path)
    # the same bytes, so either reads the other's file
    with open(port_path, "rb") as f1, open(jax_path, "rb") as f2:
        assert f1.read() == f2.read()
    back = port_io.binary_read(jax_path, device="cpu")
    assert back.matrix_type == pm.matrix_type and back.dtype == pm.dtype
    assert same_bits(back, jm)
    assert pdt.checksum(back) == pdt.checksum(pm)
    assert pdt.checksum(back, pos=True) == pdt.checksum(pm, pos=True)
    jback = jax_io.binary_read(port_path)
    assert jback.matrix_type == jm.matrix_type and np.dtype(jback.dtype) == np.dtype(dtype)
    assert same_bits(pm, jback)
    np.testing.assert_array_equal(np.asarray(jdt.to_dense(jback)), pdt.to_dense(pm))


def test_binary_read_takes_a_name_and_a_distribution(tmp_path):
    _, pm = pair(5, [2, 3], [2, 2], occ=1.0)
    path = str(tmp_path / "m.dbcsr")
    port_io.binary_write(pm, path)
    dist = pdt.Distribution([0, 1], [0, 0], pdt.ProcessGrid(2, 1))
    back = port_io.binary_read(path, dist=dist, name="renamed", device="cpu")
    assert back.name == "renamed" and back.dist is dist and back.device.type == "cpu"
    np.testing.assert_array_equal(pdt.to_dense(back), pdt.to_dense(pm))


def test_binary_read_rejects_garbage(tmp_path):
    p = tmp_path / "bad.bin"
    p.write_bytes(b"NOTDBCSR" + b"\0" * 64)
    with pytest.raises(ValueError):
        port_io.binary_read(str(p), device="cpu")
    _, pm = pair(6, [2, 3], [2, 2], occ=1.0)
    good = tmp_path / "good.dbcsr"
    port_io.binary_write(pm, str(good))
    raw = good.read_bytes()
    cut = tmp_path / "cut.dbcsr"
    cut.write_bytes(raw[:-8])
    with pytest.raises(ValueError, match="truncated"):
        port_io.binary_read(str(cut), device="cpu")


def test_binary_write_refuses_bf16_and_unfinalized(tmp_path):
    m = pdt.create("b", [2], [2], dtype=torch.bfloat16, device="cpu")
    m.put_block(0, 0, np.ones((2, 2)))
    m.finalize()
    with pytest.raises(TypeError):
        port_io.binary_write(m, str(tmp_path / "b.dbcsr"))
    m.put_block(0, 0, np.ones((2, 2)))  # staged, not finalized
    with pytest.raises(RuntimeError):
        port_io.binary_write(m, str(tmp_path / "b.dbcsr"))


# -------------------------------------------------------------- csr_type API
def test_csr_create_from_matrix_dists():
    jm, pm = pair(7, [3, 4, 2], [2, 3, 4], occ=0.8)
    for fmt in (pdt.CSR_EQROW_CEIL_DIST, pdt.CSR_EQROW_FLOOR_DIST, pdt.CSR_DBCSR_BLKROW_DIST):
        csr = pdt.csr_create_from_matrix(pm, nprocs=3, dist_format=fmt)
        ref = jdt.csr_create_from_matrix(jm, nprocs=3, dist_format=fmt)
        assert (csr.nrows, csr.ncols, csr.nze) == (ref.nrows, ref.ncols, ref.nze) == (9, 9, csr.nze)
        np.testing.assert_array_equal(csr.row_dist, ref.row_dist)
        np.testing.assert_array_equal(csr.data, ref.data)
        assert (np.diff(csr.row_dist) >= 0).all() and csr.row_dist.max() <= 2
    csr = pdt.csr_create_from_matrix(pm, nprocs=3, dist_format=pdt.CSR_DBCSR_BLKROW_DIST)
    bounds = np.concatenate([[0], np.cumsum([3, 4, 2])])
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        assert len(set(csr.row_dist[b0:b1])) == 1
    with pytest.raises(ValueError):
        pdt.csr_create_from_matrix(pm, dist_format=9)


def test_to_csr_filter_template():
    m = pdt.create("m", [2, 2], [2, 2], device="cpu")
    m.put_block(0, 0, np.array([[1e-8, 0.5], [2.0, 1e-12]]))
    m.finalize()
    np.testing.assert_array_equal(pdt.to_dense(pdt.to_csr_filter(m, 1e-6))[:2, :2],
                                  [[0.0, 1.0], [1.0, 0.0]])
    np.testing.assert_array_equal(pdt.to_dense(pdt.to_csr_filter(m, 0.0))[:2, :2], 1.0)
    jm, pm = pair(8, [2, 3], [3, 2], occ=1.0)
    assert same_bits(pdt.to_csr_filter(pm, 0.5), jdt.to_csr_filter(jm, 0.5))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_csr_write_and_print_sparsity(dtype):
    jm, pm = pair(9, [2, 3], [3, 2], occ=1.0, dtype=dtype)
    csr, ref = pdt.csr_create_from_matrix(pm), jdt.csr_create_from_matrix(jm)
    for kw in ({}, {"upper_triangle": True, "threshold": 0.5}):
        buf, jbuf = io.StringIO(), io.StringIO()
        pdt.csr_write(csr, buf, **kw)
        jdt.csr_write(ref, jbuf, **kw)
        assert buf.getvalue() == jbuf.getvalue()
    buf = io.StringIO()
    pdt.csr_write(csr, buf)
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == csr.nze and int(lines[0].split()[0]) >= 1
    buf, jbuf = io.StringIO(), io.StringIO()
    pdt.csr_print_sparsity(csr, buf)
    jdt.csr_print_sparsity(ref, jbuf)
    assert "non-zero" in buf.getvalue() and buf.getvalue() == jbuf.getvalue()


def test_csr_write_binary(tmp_path):
    jm, pm = pair(10, [2, 3], [3, 2], occ=1.0)
    pdt_path, jax_path = tmp_path / "p.bin", tmp_path / "j.bin"
    with open(pdt_path, "wb") as f:
        pdt.csr_write(pdt.csr_create_from_matrix(pm), f, binary=True)
    with open(jax_path, "wb") as f:
        jdt.csr_write(jdt.csr_create_from_matrix(jm), f, binary=True)
    assert pdt_path.read_bytes() == jax_path.read_bytes()
    invalid = pdt.CsrMatrix(1, 1, [0, 0], [], np.zeros(0))
    invalid.valid = False
    with pytest.raises(RuntimeError):
        pdt.csr_write(invalid, io.StringIO())
