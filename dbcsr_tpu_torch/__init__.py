"""dbcsr_tpu_torch: the PyTorch/CUDA port of dbcsr_tpu.

Block-sparse (BCSR) matrices and their stack-format multiply on an
NVIDIA GPU, with the stack of small block products computed by a CUDA
kernel written for Hopper (``csrc/smm_stack.cu``, built with nvcc at
first use).  The JAX package ``dbcsr_tpu`` is the reference this port is
tested against; this package imports nothing of it.

Entry points place their tensors on the default device, "cuda" unless
`dbcsr_tpu_torch.device.set_default_device` or a ``device=`` argument
says otherwise.

    from dbcsr_tpu_torch.perf.driver import parse_perf_file, run_perf
    run_perf(parse_perf_file("tests/inputs/test_H2O.perf"))
"""
