"""dbcsr_tpu_torch.utils: the debug-gated lock-order checker (`lockcheck`).

Counterpart of `dbcsr_tpu/utils/`.  `compat` (JAX version shims),
`sync` (replaced by `torch.cuda.synchronize`) and `rounding` (no jit
cache to bucket for) have no counterpart.
"""
