"""Global configuration: the subset of `dbcsr_tpu/core/config.py` the
stack-format multiply reads (ref `dbcsr_cfg`, `src/core/dbcsr_config.F`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # stack driver: "auto" launches the CUDA stack kernel on a CUDA
    # tensor and runs its plain PyTorch version on a CPU tensor; "torch"
    # runs the plain version on any device (the on-card comparison leg)
    mm_driver: str = "auto"
    # entries the plain version gathers per chunk (bounds its temporary
    # memory; ref MM_STACK_SIZE, dbcsr_config.F:77-79)
    mm_stack_size: int = 30000
    # check the stack kernel against a float64 host oracle on first use
    # per (m, n, k, dtype) (ref libsmm_acc.cpp:216 validate_kernel)
    validate_kernels: bool = True
    # execution format; only the BCSR stack path is ported
    mm_format: str = "stack"

    def validate(self) -> None:
        if self.mm_driver not in ("auto", "torch"):
            raise ValueError(f"mm_driver must be 'auto'/'torch', "
                             f"got {self.mm_driver!r}")
        if self.mm_stack_size <= 0:
            raise ValueError("mm_stack_size must be positive")
        if self.mm_format != "stack":
            raise ValueError(f"mm_format must be 'stack' (the only format "
                             f"ported), got {self.mm_format!r}")


_cfg = Config()


def get_config() -> Config:
    return _cfg


def set_config(**kwargs) -> None:
    """Programmatic config update (ref `dbcsr_set_config`).  Validates a
    candidate copy first, so a rejected update leaves the config as it
    was."""
    for k in kwargs:
        if not hasattr(_cfg, k):
            raise ValueError(f"unknown config key {k!r}")
    candidate = dataclasses.replace(_cfg, **kwargs)
    candidate.validate()
    for k, v in kwargs.items():
        setattr(_cfg, k, v)
