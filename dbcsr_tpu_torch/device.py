"""The device seam: where the port's tensors live.

Entry points run on the CUDA card unless the caller asks for the CPU,
either per call (``device="cpu"``) or process-wide
(`set_default_device("cpu")`, which the CPU test suite uses).  A CUDA
request on a machine without a card raises; nothing quietly continues
on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device]

_default = torch.device("cuda")


def default_device() -> torch.device:
    """The device entry points use when the caller names none."""
    return _default


def set_default_device(device: DeviceLike) -> None:
    """Set the process-wide default device ("cuda", "cuda:1", "cpu")."""
    global _default
    _default = torch.device(device)


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
    """The device to place work on: ``device`` when given, else the
    default.  Raises when a CUDA device is asked for and none exists."""
    dev = torch.device(device) if device is not None else _default
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                f"False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
