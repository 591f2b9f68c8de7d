"""Global configuration: the subset of `dbcsr_tpu/core/config.py` the
multiply, the TAS split, the grid engines, the integrity plane, the
statistics and the serving plane read
(ref `dbcsr_cfg`, `src/core/dbcsr_config.F`).  Every field is set in
code (`set_config`); none is read from the environment.
"""

from __future__ import annotations

import dataclasses

MM_DRIVERS = ("auto", "pallas", "pallas_cross", "torch", "host")
ABFT_MODES = ("off", "verify", "recover")
MM_FORMATS = ("auto", "stack", "dense", "composite")
PRECISION_MODES = ("native", "adaptive", "f32", "bf16")
INCREMENTAL_MODES = ("auto", "off", "full")
SUPERSTACK_MODES = ("auto", "fused", "per_span")


@dataclasses.dataclass
class Config:
    # stack driver (the JAX package's names): "auto" picks the kernel
    # per stack (acc/smm.py: crosspack for an untuned float32/bfloat16
    # stack on the card or a tuned crosspack row, else the base kernel);
    # "pallas" forces the base stack kernel and "pallas_cross" the
    # crosspack kernel (the base kernel where the pack has P <= 1);
    # "torch" runs the base kernel's plain PyTorch version on any device
    # (the on-card comparison leg); "host" runs the native C++ stack
    # driver (native/host_smm.cpp) and serves CPU tensors only (a CUDA
    # tensor raises).  A kernel runs its plain version on a CPU tensor.
    # "pallas" also keeps every product on the stack format, as in the
    # JAX package.
    mm_driver: str = "auto"
    # entries the plain version gathers per chunk (bounds its temporary
    # memory; ref MM_STACK_SIZE, dbcsr_config.F:77-79)
    mm_stack_size: int = 30000
    # check the stack kernel against a float64 host oracle on first use
    # per (m, n, k, dtype) (ref libsmm_acc.cpp:216 validate_kernel)
    validate_kernels: bool = True
    # execution format of a product (mm/format_planner.py): "auto" (the
    # planner picks stack, dense or composite), or a forced "stack",
    # "dense" or "composite" (a forced format the product cannot take
    # runs the stack format, reason "ineligible")
    mm_format: str = "auto"
    # dense mode for near-full products (ref MM_DENSE, dbcsr_mm.F:593-617):
    # None = decided by the occupancy threshold, True forces, False forbids
    mm_dense: object = None
    dense_occ_threshold: float = 0.8
    # composite panel packing (mm/multiply.py:composite_panels): the most
    # row panels one batched GEMM carries, and the largest fraction of
    # the k dimension a panel's k-support may span
    composite_max_panels: int = 64
    composite_ksup: float = 0.75
    # multiplier on the TAS split-factor estimate (tas/mm.py; ref
    # TAS_SPLIT_FACTOR, dbcsr_config.F:170)
    tas_split_factor: float = 1.0
    # ABFT probe checksums at the stack and canvas boundaries
    # (acc/abft.py): "off" (no probe), "verify" (a rank-1 probe per
    # launch; a mismatch is classified "sdc" and the stack re-executes
    # down the failover chain), "recover" (verify, and every recovery is
    # itself probed).  It also arms the models' chain guard
    # (models/integrity.py).
    abft: str = "off"
    # compute dtype of the stack engine (acc/precision.py): "native"
    # (every stack at its own dtype), "adaptive" (demote eligible stacks
    # -- float64 to float32 off a TPU -- with wide accumulation, each
    # launch certified by the ABFT probe and promoted back to native per
    # (m, n, k, dtype) cell on a breach; inert unless ``abft`` is on),
    # "f32"/"bf16" (force the demoted compute dtype with two-product
    # compensation, no certificate: test and comparison legs)
    precision: str = "native"
    # fused superstack launches (acc/smm.py:execute_superstack): every C
    # bin whose spans can fuse runs them as one launch ("auto" resolves
    # to "fused"); "per_span" launches each span on its own (the
    # comparison leg).  Single-span bins run per span either way.
    superstack: str = "auto"
    # keep the multiply statistics (core/stats.py: per-(m,n,k) and
    # per-driver flops, bytes and seconds, the memory meters)
    keep_stats: bool = True
    # the delta-aware incremental multiply (mm/incremental.py): "auto"
    # (a repeated beta = 0 product whose operands changed in a known set
    # of blocks recomputes only the C blocks those reach and splices the
    # rest from the cached result, bit for bit the full product), "off"
    # (no tracking, no cache), "full" (keep the cache but always
    # recompute: the comparison leg that pays the bookkeeping)
    incremental: str = "auto"
    # the grid engines' tick pipeline (parallel/overlap.py): "auto"
    # double-buffers whenever the grid shifts panels, "double_buffer"
    # forces it, "serial" runs each tick's products, then its shift
    cannon_overlap: str = "auto"
    # 2.5D k layers of an automatically shaped grid (ref NUM_LAYERS_3D,
    # dbcsr_config.F:152): 0 lets `parallel.mesh.grid_shape` choose
    num_layers_3d: int = 0
    # ---- serving plane (serve/), the JAX package's defaults ----
    # bound on queued requests; beyond it submissions shed queue_full
    serve_queue_max: int = 256
    # the batching window: how long the worker waits for more requests
    # of the same coalesce key after popping one (0: only requests
    # already queued group)
    serve_window_ms: float = 5.0
    # block-diagonal composite execution on or off (off: every request
    # runs serialized, the comparison leg)
    serve_coalesce: bool = True
    # largest request group one composite multiply carries
    serve_coalesce_max: int = 8
    # per-tenant quotas: queued + running requests, and queued operand
    # bytes (A + B + C)
    serve_tenant_inflight: int = 8
    serve_tenant_bytes: int = 256 * 1024 * 1024
    # deadline given under a DEGRADED verdict to a request without one
    serve_degraded_deadline_s: float = 10.0
    # the content-addressed product cache (serve/product_cache.py) and
    # its bounds
    serve_product_cache: bool = True
    serve_product_cache_entries: int = 32
    serve_product_cache_bytes: int = 128 * 1024 * 1024

    def validate(self) -> None:
        if self.mm_driver not in MM_DRIVERS:
            raise ValueError(f"mm_driver must be one of "
                             f"{'/'.join(repr(d) for d in MM_DRIVERS)}, "
                             f"got {self.mm_driver!r}")
        if self.mm_stack_size <= 0:
            raise ValueError("mm_stack_size must be positive")
        if self.mm_format not in MM_FORMATS:
            raise ValueError(f"mm_format must be 'auto'/'stack'/'dense'/'composite', "
                             f"got {self.mm_format!r}")
        if self.composite_max_panels < 2:
            raise ValueError("composite_max_panels must be >= 2")
        if not 0.0 < self.composite_ksup <= 1.0:
            raise ValueError("composite_ksup must be in (0, 1]")
        if self.tas_split_factor <= 0:
            raise ValueError("tas_split_factor must be positive")
        if self.abft not in ABFT_MODES:
            raise ValueError(f"abft must be 'off'/'verify'/'recover', got {self.abft!r}")
        if self.precision not in PRECISION_MODES:
            raise ValueError(f"precision must be 'native'/'adaptive'/'f32'/'bf16', "
                             f"got {self.precision!r}")
        if self.superstack not in SUPERSTACK_MODES:
            raise ValueError(f"superstack must be 'auto'/'fused'/'per_span', "
                             f"got {self.superstack!r}")
        if self.incremental not in INCREMENTAL_MODES:
            raise ValueError(f"incremental must be 'auto'/'off'/'full', "
                             f"got {self.incremental!r}")
        if self.cannon_overlap not in ("auto", "double_buffer", "serial"):
            raise ValueError(f"cannon_overlap must be 'auto'/'double_buffer'/'serial', "
                             f"got {self.cannon_overlap!r}")
        if self.num_layers_3d < 0:
            raise ValueError("num_layers_3d must be >= 0")
        if self.serve_queue_max <= 0:
            raise ValueError("serve_queue_max must be positive")
        if self.serve_window_ms < 0:
            raise ValueError("serve_window_ms must be >= 0")
        if self.serve_coalesce_max < 1:
            raise ValueError("serve_coalesce_max must be >= 1")
        if self.serve_tenant_inflight <= 0:
            raise ValueError("serve_tenant_inflight must be positive")
        if self.serve_tenant_bytes <= 0:
            raise ValueError("serve_tenant_bytes must be positive")
        if self.serve_degraded_deadline_s <= 0:
            raise ValueError("serve_degraded_deadline_s must be positive")
        if self.serve_product_cache_entries < 1:
            raise ValueError("serve_product_cache_entries must be >= 1")
        if self.serve_product_cache_bytes <= 0:
            raise ValueError("serve_product_cache_bytes must be positive")


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


def print_config(out=print) -> None:
    """Ref `dbcsr_print_config`: one line per field."""
    for f in dataclasses.fields(Config):
        out(f"  dbcsr_tpu_torch.{f.name:<28} {getattr(_cfg, f.name)}")


def get_default_config() -> Config:
    """A fresh Config with the defaults (ref `dbcsr_get_default_config`,
    `dbcsr_api.F:175`)."""
    return Config()
