"""dbcsr_tpu_torch: the PyTorch/CUDA port of dbcsr_tpu.

Block-sparse (BCSR) matrices and their multiply on an NVIDIA GPU: the
stack format, whose small block products run in CUDA kernels written
for Hopper (``csrc/``, built with nvcc at first use) after a C++ index
engine plans them on the host (``native/``, built with g++ at first
use), and the dense and composite formats, picked per product by
``mm/format_planner.py``.  The JAX package ``dbcsr_tpu`` is the reference this port is
tested against; this package imports nothing of it.

Entry points place their tensors on the default device, "cuda" unless
`dbcsr_tpu_torch.device.set_default_device` or a ``device=`` argument
says otherwise.

    from dbcsr_tpu_torch.perf.driver import parse_perf_file, run_perf
    run_perf(parse_perf_file("tests/inputs/test_H2O.perf"))
"""
