"""Host planning of the crosspack stack kernel.

Counterpart of the host side of `dbcsr_tpu/acc/pallas_smm.py`
(`choose_pack` :323, `build_crosspack_stack` :341,
`supports_vmem_resident` :616, `prepare_crosspack_launches` :620).  On
the TPU, P runs were dealt onto lanes of one packed MXU dot; here the
runs (one per destination C block of a stack sorted by C block) are
sorted by length and dealt into packs of P consecutive runs, one pack
per CUDA thread block (`csrc/smm_crosspack.cu`).  There are no pad
entries, no per-lane outputs, no capacity buckets and no cap on the
entries of a launch: a span is one launch, whatever its length.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from dbcsr_tpu_torch.acc import crosspack_kernel


def choose_pack(m: int, n: int, k: int, max_streams: int = 40) -> Tuple[int, int]:
    """Pick (P, R): P runs side by side and R entries per step.  A copy
    of the JAX package's rule, so tuned rows and tests agree on (P, R):
    P*max(m, n) and R*k each aim to fill (not exceed) 128, and
    2*P*R + 2*P is capped at ``max_streams``."""
    P = max(1, min(8, 128 // max(m, n)))
    R = max(1, min(8, 128 // k))
    while P * R * 2 + 2 * P > max_streams:
        if R >= P and R > 1:
            R -= 1
        elif P > 1:
            P -= 1
        else:
            break
    return P, R


def runs(c_idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(run_ptr, run_c) of a stack sorted by destination block."""
    starts = np.concatenate([[0], np.flatnonzero(np.diff(c_idx)) + 1])
    return np.append(starts, len(c_idx)), c_idx[starts]


@dataclasses.dataclass
class PackLayout:
    """A stack in the crosspack kernel's layout (host arrays).

    ``pack_runs[i * P + p]`` is the run in slot p of pack i, -1 for an
    empty slot; runs are sorted by length, descending and stable, so the
    runs of one pack have near-equal length and slot 0 holds the pack's
    longest."""

    P: int
    R: int
    run_ptr: np.ndarray  # (nruns + 1,)
    run_c: np.ndarray    # (nruns,)
    pack_runs: np.ndarray  # int32 (npacks * P,)

    @property
    def npacks(self) -> int:
        return len(self.pack_runs) // self.P

    @property
    def pack_longest(self) -> np.ndarray:
        """Entries of the longest run of each pack."""
        return np.diff(self.run_ptr)[self.pack_runs[::self.P]]


def prepare_crosspack(c_idx: np.ndarray, pack: Tuple[int, int]) -> Optional[PackLayout]:
    """The pack layout of a stack sorted by ``c_idx``, or None when
    ``pack`` has P <= 1 (nothing to pack side by side: the stack takes
    the base kernel, as in the JAX package)."""
    P, R = int(pack[0]), int(pack[1])
    if P <= 1:
        return None
    if R < 1:
        raise ValueError(f"pack {pack}: R must be positive")
    run_ptr, run_c = runs(np.asarray(c_idx))
    order = np.argsort(-np.diff(run_ptr), kind="stable")
    npacks = -(-len(order) // P)
    pack_runs = np.full(npacks * P, -1, np.int32)
    pack_runs[:len(order)] = order
    return PackLayout(P, R, run_ptr, run_c, pack_runs)


def resident_limit_bytes(device) -> int:
    """Bytes of operands the resident variant (K4) may keep on chip: the
    card's persisting-L2 limit, read at run time.  On the CPU the plain
    version keeps nothing on chip, so nothing limits it."""
    if getattr(device, "type", device) == "cpu":
        return np.iinfo(np.int64).max
    return crosspack_kernel.persisting_l2_bytes(device)


def supports_resident(a_data, b_data) -> bool:
    """The K4 gate: A's and B's bins fit the persisting-L2 limit."""
    nbytes = (a_data.numel() * a_data.element_size()
              + b_data.numel() * b_data.element_size())
    return nbytes <= resident_limit_bytes(a_data.device)
