"""Datatype kinds: the reference dtype enum mapped onto torch dtypes.

Counterpart of `dbcsr_tpu/core/kinds.py`.  The enum values match the
reference (`acc_libsmm.h`: r4=1, r8=3, c4=5, c8=7) plus bf16=9, so the
`.perf` inputs read the same.
"""

from __future__ import annotations

import numpy as np
import torch

dbcsr_type_real_4 = 1
dbcsr_type_real_8 = 3
dbcsr_type_complex_4 = 5
dbcsr_type_complex_8 = 7
dbcsr_type_bfloat16 = 9

_ENUM_TO_DTYPE = {
    dbcsr_type_real_4: torch.float32,
    dbcsr_type_real_8: torch.float64,
    dbcsr_type_complex_4: torch.complex64,
    dbcsr_type_complex_8: torch.complex128,
    dbcsr_type_bfloat16: torch.bfloat16,
}
_DTYPE_TO_ENUM = {v: k for k, v in _ENUM_TO_DTYPE.items()}
_BY_NAME = {str(dt).replace("torch.", ""): dt for dt in _DTYPE_TO_ENUM}

# numpy dtype used for host-side staging of each torch dtype (numpy has
# no bfloat16: bf16 blocks are staged in float32 and rounded on upload)
_HOST_DTYPE = {
    torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
    torch.complex64: np.dtype(np.complex64),
    torch.complex128: np.dtype(np.complex128),
    torch.bfloat16: np.dtype(np.float32),
}
_REAL_OF = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def dtype_of(kind) -> torch.dtype:
    """Resolve a dbcsr kind enum, torch dtype, numpy dtype or dtype name
    to a torch dtype."""
    if isinstance(kind, torch.dtype):
        dt = kind
    elif isinstance(kind, (int, np.integer)) and not isinstance(kind, bool):
        if int(kind) not in _ENUM_TO_DTYPE:
            raise ValueError(f"unknown data type enum {kind!r}")
        dt = _ENUM_TO_DTYPE[int(kind)]
    else:
        name = kind if isinstance(kind, str) else getattr(kind, "name", None)
        if name is None:
            name = np.dtype(kind).name
        dt = _BY_NAME.get(str(name))
        if dt is None:
            raise ValueError(f"unsupported dtype {kind!r}")
    if dt not in _DTYPE_TO_ENUM:
        raise ValueError(f"unsupported dtype {dt}")
    return dt


def enum_of(dtype) -> int:
    """Inverse of :func:`dtype_of`."""
    return _DTYPE_TO_ENUM[dtype_of(dtype)]


def host_dtype(dtype) -> np.dtype:
    """The numpy dtype blocks of ``dtype`` are staged in on the host."""
    return _HOST_DTYPE[dtype_of(dtype)]


def name_of(dtype) -> str:
    """The dtype's name as the reference tolerances key it ("float64")."""
    return str(dtype_of(dtype)).replace("torch.", "")


def is_complex(dtype) -> bool:
    return dtype_of(dtype).is_complex


def real_dtype_of(dtype) -> torch.dtype:
    """The real dtype of matching precision (for norms): complex64 ->
    float32, complex128 -> float64, a real dtype itself."""
    dt = dtype_of(dtype)
    return _REAL_OF.get(dt, dt)
