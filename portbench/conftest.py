"""Test settings of the benchmark's own tests (``pytest portbench/tests``).

Tests that need an NVIDIA GPU carry the ``card`` marker and take the
``card`` fixture, which skips them where no CUDA device is visible; the
rest run on the CPU, the program on its CPU path.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.fixture
def on_cpu():
    """The program's default device set to the CPU for the test."""
    from dbcsr_tpu_torch import device

    old = device.default_device()
    device.set_default_device("cpu")
    yield torch.device("cpu")
    device.set_default_device(old)
