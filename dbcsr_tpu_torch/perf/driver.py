"""Performance driver: the `dbcsr_perf` analog on one device.

Counterpart of `dbcsr_tpu/perf/driver.py` (ref
`tests/dbcsr_performance_driver.F` + `dbcsr_performance_multiply.F`):
parse a `.perf` input, draw A, B and C from one numpy Generator in the
JAX package's order (seed 12341313), run ``nrep`` multiplies on a copy
of C each, and check the checksums against the input's references
(complex kinds included: the checksum sums |c|^2, the positional one
the real parts).  Timing fences with `torch.cuda.synchronize()` on the
card.  The repeats run with the incremental multiply off
(`mm/incremental.py`), as in the JAX package
(`dbcsr_tpu/perf/driver.py:278-292`): a repeat of an unchanged beta = 0
product would otherwise be served from the result cache, and the
repeats must time the engine.

Usage:  python -m dbcsr_tpu_torch.perf.driver tests/inputs/test_H2O.perf [cpu]
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from dbcsr_tpu_torch.acc import crosspack_kernel, stack_kernel
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.kinds import dtype_of
from dbcsr_tpu_torch.device import DeviceLike, resolve_device
from dbcsr_tpu_torch.mm.multiply import multiply
from dbcsr_tpu_torch.ops.test_methods import checksum as matrix_checksum
from dbcsr_tpu_torch.ops.test_methods import make_random_matrix


@dataclasses.dataclass
class PerfConfig:
    npcols: int = 0
    use_rma: bool = False
    operation: str = "dbcsr_multiply"
    m: int = 1000
    n: int = 1000
    k: int = 1000
    sparsity_a: float = 0.0
    sparsity_b: float = 0.0
    sparsity_c: float = 0.0
    transa: str = "N"
    transb: str = "N"
    symm_a: str = "N"
    symm_b: str = "N"
    symm_c: str = "N"
    data_type: int = 3
    alpha: complex = 1.0
    beta: complex = 1.0
    limits: Tuple[int, int, int, int, int, int] = (0, 0, 0, 0, 0, 0)
    retain_sparsity: bool = False
    nrep: int = 1
    m_sizes: List[Tuple[int, int]] = dataclasses.field(default_factory=lambda: [(1, 5)])
    n_sizes: List[Tuple[int, int]] = dataclasses.field(default_factory=lambda: [(1, 5)])
    k_sizes: List[Tuple[int, int]] = dataclasses.field(default_factory=lambda: [(1, 5)])
    check: bool = False
    check_threshold: float = 0.0
    check_refs: Tuple[float, float] = (0.0, 0.0)


class PerfChecksumError(RuntimeError):
    """checksum(C_out) disagrees with the input's reference value (ref
    'Wrong Checksums. Test failed!', `dbcsr_performance_multiply.F:673-675`)."""


def _fortran_bool(tok: str) -> bool:
    return tok.strip().upper().startswith("T")


def _fortran_float(tok: str) -> float:
    return float(tok.strip().lower().replace("d", "e"))


def parse_perf_file(path: str) -> PerfConfig:
    """Parse the reference `.perf` format: positional values, '#' comments."""
    with open(path) as f:
        toks = [ln.strip() for ln in f if ln.strip() and not ln.strip().startswith("#")]
    it = iter(toks)
    nx = lambda: next(it)  # noqa: E731
    cfg = PerfConfig()
    cfg.npcols = int(nx())
    cfg.use_rma = _fortran_bool(nx())
    cfg.operation = nx()
    cfg.m, cfg.n, cfg.k = int(nx()), int(nx()), int(nx())
    cfg.sparsity_a = _fortran_float(nx())
    cfg.sparsity_b = _fortran_float(nx())
    cfg.sparsity_c = _fortran_float(nx())
    cfg.transa, cfg.transb = nx(), nx()
    cfg.symm_a, cfg.symm_b, cfg.symm_c = nx(), nx(), nx()
    cfg.data_type = int(nx())
    ar, ai_ = _fortran_float(nx()), _fortran_float(nx())
    br, bi = _fortran_float(nx()), _fortran_float(nx())
    cfg.alpha = complex(ar, ai_) if ai_ else ar
    cfg.beta = complex(br, bi) if bi else br
    cfg.limits = tuple(int(nx()) for _ in range(6))
    cfg.retain_sparsity = _fortran_bool(nx())
    cfg.nrep = int(nx())
    nm, nn, nk = int(nx()), int(nx()), int(nx())
    cfg.m_sizes = [(int(nx()), int(nx())) for _ in range(nm)]
    cfg.n_sizes = [(int(nx()), int(nx())) for _ in range(nn)]
    cfg.k_sizes = [(int(nx()), int(nx())) for _ in range(nk)]
    cfg.check = _fortran_bool(nx())
    cfg.check_threshold = _fortran_float(nx())
    cfg.check_refs = (_fortran_float(nx()), _fortran_float(nx()))
    return cfg


def expand_block_sizes(total: int, pattern: List[Tuple[int, int]]) -> np.ndarray:
    """Cycle (multiplicity, size) pairs until ``total`` is covered."""
    sizes = []
    covered = 0
    while covered < total:
        for mult, size in pattern:
            for _ in range(mult):
                take = min(size, total - covered)
                if take <= 0:
                    break
                sizes.append(take)
                covered += take
            if covered >= total:
                break
    return np.asarray(sizes, np.int32)


def _element_limits(lim_lo: int, lim_hi: int) -> Tuple[Optional[int], Optional[int]]:
    """1-based `.perf` limits (0 = open) as 0-based inclusive element
    limits for `multiply(element_limits=...)`, each side open or not on
    its own (ref `dbcsr_performance_multiply.F:171-178`)."""
    return (None if lim_lo == 0 else lim_lo - 1,
            None if lim_hi == 0 else lim_hi - 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_perf(cfg: PerfConfig, seed: int = 12341313, verbose: bool = True,
             device: Optional[DeviceLike] = None) -> dict:
    """Run the configured multiply ``nrep`` times on one device; returns
    a result dict and raises `PerfChecksumError` when the input's check
    fails (ref `perf_multiply`, `dbcsr_performance_multiply.F:452-515`)."""
    dev = resolve_device(device)
    if cfg.npcols > 1:
        raise NotImplementedError("process grids (npcols > 1) are not ported yet")
    dtype = dtype_of(cfg.data_type)
    rng = np.random.default_rng(seed)
    m_sizes = expand_block_sizes(cfg.m, cfg.m_sizes)
    n_sizes = expand_block_sizes(cfg.n, cfg.n_sizes)
    k_sizes = expand_block_sizes(cfg.k, cfg.k_sizes)
    a_rbs, a_cbs = (m_sizes, k_sizes) if cfg.transa == "N" else (k_sizes, m_sizes)
    b_rbs, b_cbs = (k_sizes, n_sizes) if cfg.transb == "N" else (n_sizes, k_sizes)
    a = make_random_matrix("A", a_rbs, a_cbs, dtype=dtype,
                           occupation=1.0 - cfg.sparsity_a,
                           matrix_type=cfg.symm_a, rng=rng, device=dev)
    b = make_random_matrix("B", b_rbs, b_cbs, dtype=dtype,
                           occupation=1.0 - cfg.sparsity_b,
                           matrix_type=cfg.symm_b, rng=rng, device=dev)
    c = make_random_matrix("C", m_sizes, n_sizes, dtype=dtype,
                           occupation=1.0 - cfg.sparsity_c,
                           matrix_type=cfg.symm_c, rng=rng, device=dev)
    el = (*_element_limits(cfg.limits[0], cfg.limits[1]),
          *_element_limits(cfg.limits[2], cfg.limits[3]),
          *_element_limits(cfg.limits[4], cfg.limits[5]))
    element_limits = el if any(x is not None for x in el) else None
    chksum_a = matrix_checksum(a)
    chksum_b = matrix_checksum(b)
    chksum_c_in = matrix_checksum(c)

    times, phases, device_s, flops_list, cache, algorithms = [], [], [], [], [], []
    counts0 = _launch_counts()
    prev_inc = get_config().incremental
    set_config(incremental="off")
    try:
        for _ in range(cfg.nrep):
            c_run = c.copy()
            _sync(dev)
            t0 = time.perf_counter()
            flops = multiply(cfg.transa, cfg.transb, cfg.alpha, a, b, cfg.beta, c_run,
                             retain_sparsity=cfg.retain_sparsity, element_limits=element_limits)
            _sync(dev)
            times.append(time.perf_counter() - t0)
            flops_list.append(flops)
            phases.append(dict(c_run._mm_phase_s))
            cache.append(c_run._mm_plan_cache)
            algorithms.append(c_run._mm_algorithm)
            ev = c_run._mm_device_events
            device_s.append(ev[0].elapsed_time(ev[1]) / 1e3 if ev else None)
    finally:
        set_config(incremental=prev_inc)
    launches = {name: n - counts0[name] for name, n in _launch_counts().items()}
    gflops = [f / t / 1e9 for f, t in zip(flops_list, times)]
    cs = matrix_checksum(c_run)
    cs_pos = matrix_checksum(c_run, pos=True)
    result = {
        "times_s": times,
        # host seconds inside multiply per phase (the format decision;
        # for the stack format the index build, C assembly, stack
        # planning and launch calls, else the dense or composite call)
        # and device seconds of the format's device work (CUDA events
        # around the stacks or the canvas work; None on the CPU)
        "host_s": [sum(p.values()) for p in phases],
        "host_phase_s": phases,
        "device_s": device_s,
        # each repeat's plan-cache outcome: "miss", then "hit" for the
        # repeats of the same product (mm/multiply.py); None off the
        # stack format
        "plan_cache": cache,
        # kernel launches over all repeats by kernel (first-use
        # validations included), calls of the plain versions, and the
        # last repeat's spans as (m, n, k, entries, kernel, longest run)
        "launches": launches,
        "spans": c_run._mm_spans,
        "flops": flops_list[-1],
        "gflops_mean": float(np.mean(gflops)),
        "gflops_std": float(np.std(gflops)),
        "gflops_best": float(np.max(gflops)),
        "checksum": cs,
        "checksum_pos": cs_pos,
        "checksum_a": chksum_a,
        "checksum_b": chksum_b,
        "checksum_c_in": chksum_c_in,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        # the format the planner chose (mm/format_planner.py): the last
        # repeat's, as the JAX driver reports it, and each repeat's
        "algorithm": algorithms[-1],
        "algorithms": algorithms,
        # the operands and the last repeat's product, for callers that
        # inspect the run further (chip_smoke.py re-plans its stacks)
        "matrices": {"a": a, "b": b, "c_out": c_run},
    }
    if verbose:
        print(f" matrix sizes M/N/K          {cfg.m} {cfg.n} {cfg.k}")
        print(f" sparsities A/B/C            {cfg.sparsity_a} {cfg.sparsity_b} {cfg.sparsity_c}")
        print(f" device                      {result['device']}")
        print(f" flops per multiply          {result['flops']:,}")
        print(f" time per multiply           {[f'{t:.4f}' for t in times]}")
        print(f" perf total                  {result['gflops_mean']:.2f} +/- "
              f"{result['gflops_std']:.2f} GFLOP/s (best {result['gflops_best']:.2f})")
        print(f" checksum(A)                 {chksum_a:.15e}")
        print(f" checksum(B)                 {chksum_b:.15e}")
        print(f" checksum(C_in)              {chksum_c_in:.15e}")
        print(f" checksum(C_out)             {cs:.15e}")
        print(f" checksum(C_out) POS         {cs_pos:.15e}")
    if cfg.check:
        _verify_checksums(cfg, cs, cs_pos, verbose)
    return result


def _launch_counts() -> dict:
    return {"smm_stack": stack_kernel.launches,
            "smm_crosspack": crosspack_kernel.launches_cross,
            "smm_crosspack_resident": crosspack_kernel.launches_resident,
            "plain": stack_kernel.plain_calls + crosspack_kernel.plain_calls}


def _verify_checksums(cfg: PerfConfig, cs: float, cs_pos: float, verbose: bool) -> None:
    """The reference's relative-difference acceptance
    (`dbcsr_performance_multiply.F:656-675`), sign-safe for the POS
    checksum."""
    th = cfg.check_threshold
    errs = []
    for name, got, ref in (("checksum(C_out)", cs, cfg.check_refs[0]),
                           ("checksum(C_out) POS", cs_pos, cfg.check_refs[1])):
        rel_diff = abs(got - ref) / max(abs(ref), th)
        if rel_diff > th:
            errs.append(f"Wrong {name}: got {got:.15e}, ref {ref:.15e}, "
                        f"rel_diff {rel_diff:.3e} > threshold {th:.1e}")
    if errs:
        raise PerfChecksumError("; ".join(errs))
    if verbose:
        print(" checksums OK (within threshold)")


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    if not argv:
        print(__doc__)
        return 1
    try:
        run_perf(parse_perf_file(argv[0]), device=argv[1] if len(argv) > 1 else None)
    except PerfChecksumError as exc:
        print(f" {exc}")
        print(" Wrong Checksums. Test failed!")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
