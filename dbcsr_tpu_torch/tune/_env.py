"""The tune package's environment readers: a malformed value falls back to
the default (a copy of `dbcsr_tpu/tune/_env.py`).
"""

from __future__ import annotations

import os


def env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default
