"""Built-in randomized test driver.

Counterpart of `dbcsr_tpu/ops/tests.py` (ref `src/ops/dbcsr_tests.F`:
`dbcsr_run_tests` :74, test types `dbcsr_test_mm` and
`dbcsr_test_binary_io`): a user-callable harness that builds random
block-sparse matrices with random block sizes, runs the requested
operation ``n_loops`` times, and checks it against the dense oracle
(`dbcsr_test_multiply.F:523` dbcsr_check_multiply) or a round-trip
checksum.  CP2K smoke-tests a DBCSR build from application code with
it.  On the card ``TEST_MM`` runs through `mm.multiply.multiply`, so
through the stack kernels.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dbcsr_tpu_torch.core.kinds import dtype_of, real_dtype_of
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix
from dbcsr_tpu_torch.device import DeviceLike
from dbcsr_tpu_torch.mm.multiply import multiply
from dbcsr_tpu_torch.ops.test_methods import (
    checksum,
    impose_sparsity,
    make_random_matrix,
    to_dense,
)

TEST_MM = 1         # ref dbcsr_test_mm (dbcsr_tests.F:68)
TEST_BINARY_IO = 2  # ref dbcsr_test_binary_io (dbcsr_tests.F:69)


def make_random_block_sizes(total: int, pattern: Sequence[int], rng=None) -> np.ndarray:
    """A random block-size sequence covering ``total`` elements, drawn
    from a (mult1, size1, mult2, size2, ...) multiset, the last block cut
    to fit (ref `dbcsr_make_random_block_sizes`,
    `dbcsr_test_methods.F`)."""
    rng = rng or np.random.default_rng(0)
    pat = list(pattern)
    if len(pat) % 2:
        raise ValueError("pattern must be (mult, size) pairs")
    mults = np.asarray(pat[0::2], np.float64)
    sizes = np.asarray(pat[1::2], np.int64)
    probs = mults / mults.sum()
    out = []
    covered = 0
    while covered < total:
        s = min(int(rng.choice(sizes, p=probs)), total - covered)
        out.append(s)
        covered += s
    return np.asarray(out, np.int32)


class TestFailure(AssertionError):
    """A built-in test found a result outside its tolerance."""


def _check_multiply(c_out, dense_want, eps: float) -> float:
    """Elementwise comparison with the dense oracle by the reference's
    normalized criterion (`dbcsr_check_multiply:523`)."""
    got = to_dense(c_out)
    scale = max(float(np.abs(dense_want).max()), 1.0)
    err = float(np.abs(got - dense_want).max()) / scale
    if not np.isfinite(err) or err > eps:
        raise TestFailure(f"multiply result differs from dense oracle: "
                          f"max rel err {err:.3e} > eps {eps:.1e}")
    return err


def run_tests(matrix_sizes: Tuple[int, int, int], trs: Tuple[bool, bool] = (False, False),
              bs_m: Optional[Sequence[int]] = None, bs_n: Optional[Sequence[int]] = None,
              bs_k: Optional[Sequence[int]] = None,
              sparsities: Tuple[float, float, float] = (0.0, 0.0, 0.0), alpha=1.0, beta=0.0,
              data_type: int = 3, test_type: int = TEST_MM, n_loops: int = 1,
              eps: Optional[float] = None, retain_sparsity: bool = False,
              always_checksum: bool = False, seed: int = 2131, io=print,
              device: Optional[DeviceLike] = None) -> list:
    """Run the built-in randomized test on ``device`` (ref
    `dbcsr_run_tests`, `dbcsr_tests.F:74`); returns the checksum of each
    loop and raises `TestFailure` on an oracle mismatch or on loops whose
    checksums differ (the determinism contract).

    ``bs_*`` are (mult, size, ...) multisets as the reference takes them,
    None the reference default (1, 13, 2, 5).  ``eps=None`` picks a
    tolerance for the dtype (100 sqrt(k) times its resolution)."""
    rng = np.random.default_rng(seed)
    dt = dtype_of(data_type)
    if eps is None:
        eps = 100.0 * np.sqrt(matrix_sizes[2]) * torch.finfo(real_dtype_of(dt)).resolution
    default_bs = (1, 13, 2, 5)
    m_sizes = make_random_block_sizes(matrix_sizes[0], bs_m or default_bs, rng)
    n_sizes = make_random_block_sizes(matrix_sizes[1], bs_n or default_bs, rng)
    k_sizes = make_random_block_sizes(matrix_sizes[2], bs_k or default_bs, rng)

    a_rbs, a_cbs = (k_sizes, m_sizes) if trs[0] else (m_sizes, k_sizes)
    b_rbs, b_cbs = (n_sizes, k_sizes) if trs[1] else (k_sizes, n_sizes)
    a = make_random_matrix("test A", a_rbs, a_cbs, dtype=dt,
                           occupation=1.0 - sparsities[0], rng=rng, device=device)
    b = make_random_matrix("test B", b_rbs, b_cbs, dtype=dt,
                           occupation=1.0 - sparsities[1], rng=rng, device=device)
    c0 = make_random_matrix("test C", m_sizes, n_sizes, dtype=dt,
                            occupation=1.0 - sparsities[2], rng=rng, device=device)

    if test_type == TEST_BINARY_IO:
        return _run_binary_io(c0, n_loops, io)
    if test_type != TEST_MM:
        raise ValueError(f"unknown test_type {test_type}")

    def _op(mat, tr):
        d = to_dense(mat)
        return d.T if tr else d

    want = alpha * (_op(a, trs[0]) @ _op(b, trs[1])) + beta * to_dense(c0)
    if retain_sparsity:
        want = impose_sparsity(want, c0)

    checksums = []
    for loop in range(n_loops):
        c = c0.copy()
        multiply("T" if trs[0] else "N", "T" if trs[1] else "N", alpha, a, b, beta, c,
                 retain_sparsity=retain_sparsity)
        err = _check_multiply(c, want, eps)
        cs = checksum(c)
        checksums.append(cs)
        if always_checksum or loop == n_loops - 1:
            io(f" loop {loop + 1}/{n_loops}: max rel err {err:.3e}, checksum {cs:.15e}")
    if len(set(checksums)) > 1:
        raise TestFailure(f"checksums differ across {n_loops} identical multiplies: "
                          f"{sorted(set(checksums))} (determinism contract broken)")
    return checksums


def _run_binary_io(matrix: BlockSparseMatrix, n_loops: int, io) -> list:
    """Write and read back, the checksum unchanged (ref
    `dbcsr_test_binary_io`, tested via `dbcsr_tests.F:64`), in a
    temporary directory."""
    from dbcsr_tpu_torch.ops.io import binary_read, binary_write

    checksums = []
    want = checksum(matrix)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.dbcsr")
        for _ in range(n_loops):
            binary_write(matrix, path)
            got = checksum(binary_read(path, device=matrix.device))
            checksums.append(got)
            if got != want:
                raise TestFailure(f"binary I/O round trip changed the checksum: "
                                  f"{got!r} != {want!r}")
        io(f" binary_io: {n_loops} round trips OK, checksum {want:.15e}")
    return checksums
