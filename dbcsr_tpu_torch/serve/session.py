"""Serving sessions: a tenant's identity and a chain-backed matrix scope.

Counterpart of `dbcsr_tpu/serve/session.py`.  A `Session` holds a
tenant's named `BlockSparseMatrix` objects between requests; a
`core.mempool.chain` private to the session owns their storage.  The
chain is used object-style (explicit `adopt`) and never entered on the
thread's chain stack, so a session built on one client thread never
adopts matrices another tenant's thread is constructing, and `close()`
frees exactly this session's matrices.

A session lives on one device (``device``, default the card): the
matrices `create` and `random` make are placed there, and `put` refuses
a matrix on another device, since a request's operands must share one.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from dbcsr_tpu_torch.core import mempool
from dbcsr_tpu_torch.core.matrix import NO_SYMMETRY, BlockSparseMatrix
from dbcsr_tpu_torch.device import DeviceLike, resolve_device

_lock = threading.Lock()
_sessions: Dict[str, "Session"] = {}
_seq = itertools.count(1)


def matrix_nbytes(m: BlockSparseMatrix) -> int:
    """Device bytes of one matrix's bins."""
    return int(sum(b.data.numel() * b.data.element_size() for b in m.bins))


class Session:
    """One tenant's serving scope (see the module docstring)."""

    def __init__(self, tenant: str, name: Optional[str] = None,
                 register: bool = True, device: Optional[DeviceLike] = None):
        self.device = resolve_device(device)
        self.tenant = str(tenant)
        self.session_id = name or f"{self.tenant}-{next(_seq)}"
        self.t_open = time.time()
        self.closed = False
        self._matrices: Dict[str, BlockSparseMatrix] = {}
        # explicit-adopt chain, never entered as a context manager here
        # (entering pushes it on the calling thread's chain stack, and it
        # would adopt every matrix any code on that thread creates)
        self._chain = mempool.chain()
        self._mlock = threading.Lock()
        if register:
            with _lock:
                _sessions[self.session_id] = self

    # ------------------------------------------------------------ matrices

    def put(self, name: str, matrix: BlockSparseMatrix,
            adopt: bool = True) -> BlockSparseMatrix:
        """Register ``matrix`` under ``name``; with ``adopt`` (default)
        the session's chain owns it (freed at `close`).  A matrix made
        on another CUDA stream must be complete before its first
        request: the engine's worker launches on its own stream."""
        self._check_open()
        if matrix.device != self.device:
            raise ValueError(f"session {self.session_id!r} lives on {self.device}, "
                             f"matrix {matrix.name!r} on {matrix.device}")
        with self._mlock:
            if adopt:
                self._chain.adopt(matrix)
            self._matrices[name] = matrix
        return matrix

    def get(self, name: str) -> BlockSparseMatrix:
        with self._mlock:
            m = self._matrices.get(name)
        if m is None:
            raise KeyError(f"session {self.session_id!r} has no matrix {name!r}")
        return m

    def matrices(self) -> Dict[str, BlockSparseMatrix]:
        with self._mlock:
            return dict(self._matrices)

    def create(self, name: str, row_blk_sizes, col_blk_sizes,
               dtype=torch.float64,
               matrix_type: str = NO_SYMMETRY) -> BlockSparseMatrix:
        """A fresh empty matrix registered under ``name`` and adopted by
        this session's chain."""
        self._check_open()
        m = BlockSparseMatrix(f"{self.session_id}:{name}", row_blk_sizes,
                              col_blk_sizes, dtype, matrix_type=matrix_type,
                              device=self.device)
        return self.put(name, m)

    def random(self, name: str, row_blk_sizes, col_blk_sizes,
               dtype=torch.float64, occupation: float = 0.5,
               seed: int = 0) -> BlockSparseMatrix:
        """A random finalized matrix drawn from ``seed`` as the JAX
        package draws it (the per-(session, seed) generator many-client
        drivers use for same-pattern, different-value workloads)."""
        from dbcsr_tpu_torch.ops.test_methods import make_random_matrix

        self._check_open()
        m = make_random_matrix(
            f"{self.session_id}:{name}", row_blk_sizes, col_blk_sizes,
            dtype=dtype, occupation=occupation,
            rng=np.random.default_rng(seed), device=self.device)
        return self.put(name, m)

    def drop(self, name: str) -> None:
        """Free one matrix now."""
        with self._mlock:
            m = self._matrices.pop(name, None)
        if m is not None:
            self._chain.retire(m)

    def bytes_held(self) -> int:
        """Device bytes of this session's registered matrices."""
        with self._mlock:
            return sum(matrix_nbytes(m) for m in self._matrices.values())

    # ------------------------------------------------------------ lifecycle

    def _check_open(self) -> None:
        if self.closed:
            raise RuntimeError(f"session {self.session_id!r} is closed")

    def close(self) -> None:
        """Free every session-owned matrix and unregister.  Idempotent;
        caller-owned (``adopt=False``) matrices are left untouched."""
        if self.closed:
            return
        self.closed = True
        with self._mlock:
            self._matrices.clear()
        # the chain was never entered: free its adoptees directly
        self._chain.__exit__(None, None, None)
        with _lock:
            _sessions.pop(self.session_id, None)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    def __repr__(self) -> str:
        return (f"Session({self.session_id!r}, tenant={self.tenant!r}, "
                f"device={self.device}, {len(self._matrices)} matrices"
                f"{', closed' if self.closed else ''})")


def get_session(session_id: str) -> Optional[Session]:
    """Registry lookup (the HTTP routes resolve sessions by id); None
    when unknown or closed."""
    with _lock:
        return _sessions.get(session_id)


def sessions() -> Dict[str, Session]:
    with _lock:
        return dict(_sessions)

