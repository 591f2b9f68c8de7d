"""Performance driver: the `dbcsr_perf` analog.

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

Grid handling (ref `dbcsr_performance_driver.F:47-56` mp_cart_create):
``npcols > 1`` in the input, a ``grid=`` or ``n_images > 1`` runs the
product on a process grid (`parallel/`) through
`sparse_multiply_distributed`: pr = pc = npcols and any excess image
factor as 2.5D k layers; ``use_rma=T`` (the reference's one-sided 3D
algorithm, `dbcsr_mm_3d.F:1136`) prefers a layered grid from 8 images.
`run_perf_multiproc` runs the input on a world of spawned ranks
(`parallel.multihost.spawn_world`), each rank one or more images of one
grid, and checks that every rank computed the same checksum.

Usage:  python -m dbcsr_tpu_torch.perf.driver tests/inputs/test_H2O.perf [cpu]
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from dbcsr_tpu_torch.acc import crosspack_kernel, stack_kernel
from dbcsr_tpu_torch.core.config import get_config, set_config
from dbcsr_tpu_torch.core.kinds import dtype_of
from dbcsr_tpu_torch.device import DeviceLike, resolve_device
from dbcsr_tpu_torch.mm.multiply import _effective, multiply
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


def _mesh_for(cfg: PerfConfig, n_images: int, device):
    """The process grid honoring npcols/use_rma (see the module
    docstring), all images on ``device``; None runs the single-device
    engine."""
    if n_images <= 1 and cfg.npcols <= 1:
        return None
    from dbcsr_tpu_torch.parallel.mesh import Grid, make_grid

    if cfg.npcols > 0:
        s = cfg.npcols
        n_images = max(n_images, s * s)
        if n_images % (s * s):
            raise ValueError(f"npcols={s} needs an image count divisible by {s * s}, "
                             f"have {n_images}")
        kl = n_images // (s * s)
        if kl == 1 and s == 1:
            return None  # 1x1 grid: the single-device engine
        return Grid((kl, s, s), [(0, device)] * (kl * s * s))
    return make_grid(n_images, layers=2 if cfg.use_rma and n_images >= 8 else None,
                     device=device)


def run_perf(cfg: PerfConfig, seed: int = 12341313, verbose: bool = True,
             device: Optional[DeviceLike] = None, grid=None,
             n_images: Optional[int] = None) -> dict:
    """Run the configured multiply ``nrep`` times; returns a result dict
    and raises `PerfChecksumError` when the input's check fails (ref
    `perf_multiply`, `dbcsr_performance_multiply.F:452-515`) and one
    repeat on the safe driver does not pass it (`_checksum_retry_safe`;
    with ``DBCSR_TPU_TORCH_CHECKSUM_RETRY=0``, at once).  ``grid``
    (a `parallel.mesh.Grid`), ``n_images`` > 1 or npcols > 1 in the input
    runs the product on a process grid; ``grid`` overrides the rest
    (the multi-process driver passes the world's grid)."""
    dev = resolve_device(device) if grid is None else grid.home()
    if grid is None:
        grid = _mesh_for(cfg, n_images or 1, dev)
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
    # the grid engine takes plain operands: op(A), op(B) resolved once
    a_op, b_op = ((_effective(a, cfg.transa), _effective(b, cfg.transb)) if grid is not None
                  else (a, b))

    def _run_once():
        """One repeat on a fresh copy of C: (C, flops, seconds)."""
        c_run = c.copy()
        _sync(dev)
        t0 = time.perf_counter()
        if grid is not None:
            from dbcsr_tpu_torch.parallel.sparse_dist import sparse_multiply_distributed

            c_run = sparse_multiply_distributed(
                cfg.alpha, a_op, b_op, cfg.beta, c_run, grid,
                retain_sparsity=cfg.retain_sparsity, element_limits=element_limits)
            flops = c_run._last_flops
        else:
            flops = multiply(cfg.transa, cfg.transb, cfg.alpha, a, b, cfg.beta, c_run,
                             retain_sparsity=cfg.retain_sparsity,
                             element_limits=element_limits)
        _sync(dev)
        return c_run, flops, time.perf_counter() - t0

    try:
        for _ in range(cfg.nrep):
            c_run, flops, dt = _run_once()
            times.append(dt)
            flops_list.append(flops)
            phases.append(dict(getattr(c_run, "_mm_phase_s", {})))
            cache.append(getattr(c_run, "_mm_plan_cache", None))
            algorithms.append(c_run._mm_algorithm)
            ev = getattr(c_run, "_mm_device_events", None)
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
        # validations included; "smm_superstack" the fused C-bin
        # launches of K1), calls of the plain versions, and the
        # last repeat's spans as (m, n, k, entries, kernel, longest run)
        "launches": launches,
        "spans": getattr(c_run, "_mm_spans", None),
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
        "grid": dict(grid.shape) if grid is not None else {"pr": 1, "pc": 1},
        # the grid engine's last repeat: engine, overlap mode, ticks,
        # padded and true flops (None on the single-device engine)
        "mesh": getattr(c_run, "_mesh", None),
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
        try:
            _verify_checksums(cfg, cs, cs_pos, verbose)
        except PerfChecksumError as first_err:
            if os.environ.get("DBCSR_TPU_TORCH_CHECKSUM_RETRY", "1") == "0":
                raise  # a gate: the mismatch itself is the verdict
            # what the engine did for the last multiplies when the gate
            # tripped (the flight recorder), then one repeat on the safe
            # driver to classify the failure (`_checksum_retry_safe`)
            from dbcsr_tpu_torch.obs import flight

            flight.dump()
            result = _checksum_retry_safe(cfg, _run_once, cs, first_err, result, verbose)
    return result


# The driver a checksum retry runs on: the base stack kernel K1 with
# dense mode off (the corruption may live in the dense carve), as the
# models' integrity guard recomputes (`models.integrity.safe_engine`).
# The JAX package's safe driver is its plain XLA stack path, "xla"
# (`dbcsr_tpu/perf/driver.py:SAFE_DRIVER`); on the card the port's
# retry stays on a hand-written kernel, and on CPU tensors "pallas"
# runs the plain version, as "xla" does there.
SAFE_DRIVER = "pallas"


def _checksum_retry_safe(cfg: PerfConfig, run_once, cs_first: float,
                         first_err: PerfChecksumError, result: dict,
                         verbose: bool) -> dict:
    """One-shot safe-driver retry for a tripped checksum gate
    (`dbcsr_tpu/perf/driver.py:_checksum_retry_safe`).

    Re-runs ONE repeat with ``mm_driver=SAFE_DRIVER`` and dense mode off,
    and classifies the original failure:

    * the retry passes and the original run used another driver:
      ``driver``; the safe result is returned;
    * the retry passes on the same driver: ``transient``; the safe
      result is returned;
    * the retry reproduces the same wrong checksum: ``deterministic``;
      raised;
    * the retry fails with another checksum: ``unstable``; raised;
    * the retry itself raises: ``retry_error``; the original error
      stands.

    The class is counted in ``dbcsr_tpu_checksum_retry_total{outcome}``,
    published as a ``checksum_retry`` event, named in the raised message
    and returned in the result's ``checksum_retry``."""
    from dbcsr_tpu_torch.obs import events as _events
    from dbcsr_tpu_torch.obs import metrics as _metrics

    counter = _metrics.counter("dbcsr_tpu_checksum_retry_total",
                               "checksum-gate safe-driver retries by outcome")

    def _publish_retry(outcome: str) -> None:
        _events.publish("checksum_retry", {
            "outcome": outcome, "safe_driver": SAFE_DRIVER,
            "original_mm_driver": prev_driver,
            "error": str(first_err)[:300],
        })

    live = get_config()
    prev_driver, prev_dense = live.mm_driver, live.mm_dense
    retried_same_path = prev_driver == SAFE_DRIVER
    try:
        set_config(mm_driver=SAFE_DRIVER, mm_dense=False)
        c_run, _flops, _dt = run_once()
    except Exception as exc:  # the retry itself died: the original error stands
        counter.inc(outcome="retry_error")
        _publish_retry("retry_error")
        raise PerfChecksumError(
            f"{first_err}; safe-driver retry also failed "
            f"({type(exc).__name__}: {exc})") from first_err
    finally:
        set_config(mm_driver=prev_driver, mm_dense=prev_dense)
    cs = matrix_checksum(c_run)
    cs_pos = matrix_checksum(c_run, pos=True)
    try:
        _verify_checksums(cfg, cs, cs_pos, verbose=False)
    except PerfChecksumError:
        outcome = "deterministic" if cs == cs_first else "unstable"
        counter.inc(outcome=outcome)
        _publish_retry(outcome)
        again = ("reproduced the same wrong checksum" if cs == cs_first
                 else f"produced yet another checksum {cs:.15e}")
        raise PerfChecksumError(
            f"{first_err}; safe-driver ({SAFE_DRIVER}) retry {again}"
            f" — classified {outcome.upper()}") from first_err
    outcome = "transient" if retried_same_path else "driver"
    counter.inc(outcome=outcome)
    _publish_retry(outcome)
    if verbose:
        print(f" checksum gate: safe-driver retry PASSED — original "
              f"failure classified {outcome.upper()} "
              f"(driver path {prev_driver!r} -> {SAFE_DRIVER!r})")
    return dict(result, checksum=cs, checksum_pos=cs_pos,
                checksum_retry={"outcome": outcome, "failed_checksum": cs_first,
                                "safe_driver": SAFE_DRIVER,
                                "original_mm_driver": prev_driver,
                                "error": str(first_err)})


def _launch_counts() -> dict:
    return {"smm_stack": stack_kernel.launches,
            "smm_superstack": stack_kernel.superstack_launches,
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


def _mp_worker(cfg_path, images_per_proc: int, nrep: int, device) -> dict:
    """One rank of the multi-process driver (a `parallel.multihost.spawn_world`
    task): the world's grid over every rank's images, the input run on
    it, this rank's result (each rank of the reference driver is an MPI
    process doing this, `dbcsr_performance_driver.F:47-56`)."""
    from dbcsr_tpu_torch.core.digests import matrix_value_digest
    from dbcsr_tpu_torch.parallel import multihost

    grid = multihost.make_multihost_grid(images_per_process=images_per_proc, device=device)
    cfg = cfg_path if isinstance(cfg_path, PerfConfig) else parse_perf_file(cfg_path)
    if nrep:
        cfg.nrep = nrep
    multihost.reset_staged()
    res = run_perf(cfg, verbose=False, grid=grid)
    return {"pid": multihost.process_id(), "checksum": res["checksum"],
            "checksum_pos": res["checksum_pos"], "flops": res["flops"],
            "gflops_mean": res["gflops_mean"], "time_best_s": min(res["times_s"]),
            "times_s": res["times_s"], "grid": res["grid"],
            "digest": matrix_value_digest(res["matrices"]["c_out"]).hex(),
            "launches": res["launches"], "staged": multihost.staged()}


def aggregate_rank_results(results: list) -> dict:
    """World aggregation of the ranks' results: the cross-rank checksum
    contract, and the conservative world rate -- the slowest rank's best
    repeat sets the time, as the straggler sets an MPI world's wall
    clock (ref per-rank reporting, `dbcsr_performance_multiply.F:452-515`)."""
    checksums = {r["checksum"] for r in results}
    if len(checksums) != 1:
        raise RuntimeError(f"rank checksums differ: {sorted(checksums)}")
    flops = results[0]["flops"]
    t_max = max(r["time_best_s"] for r in results)
    return {
        "nproc": len(results),
        "checksum": results[0]["checksum"],
        "flops": flops,
        "gflops_world": flops / t_max / 1e9 if t_max > 0 else 0.0,
        "gflops_mean_ranks": float(np.mean([r["gflops_mean"] for r in results])),
        "per_rank": results,
    }


def run_perf_multiproc(cfg_path, nproc: int, images_per_proc: int = 1,
                       nrep: Optional[int] = None, timeout: float = 600,
                       verbose: bool = True, device: Optional[DeviceLike] = None) -> dict:
    """Run the input (a `.perf` path or a `PerfConfig`) on a world of
    ``nproc`` spawned ranks over gloo, each owning ``images_per_proc``
    images of one grid on ``device`` (the
    mpiexec-driven reference driver, `dbcsr_performance_driver.F:47-56`).
    The world runs under the ``mp_world_join`` watchdog: a world that
    does not finish within ``timeout`` seconds is WEDGED and is spawned
    once more on a fresh rendezvous directory after a backoff, a rank
    that fails is TRANSIENT (both counted in
    ``dbcsr_tpu_watchdog_outcomes_total{name="mp_world_join"}``).
    Returns the rank-aggregated result; raises when the world fails,
    overruns twice, or the ranks' checksums differ."""
    from dbcsr_tpu_torch.parallel import multihost
    from dbcsr_tpu_torch.resilience import watchdog

    dev = str(resolve_device(device))
    wd = watchdog.Watchdog("mp_world_join", deadline_s=timeout,
                           backoff_base_s=1.0, backoff_max_s=15.0)

    def attempt(deadline_s):
        # each spawn makes its own rendezvous directory
        return multihost.spawn_world("dbcsr_tpu_torch.perf.driver:_mp_worker", nproc,
                                     (cfg_path, images_per_proc, nrep or 0, dev),
                                     timeout_s=deadline_s)

    res = wd.run(attempt, retries=1, retry_on=(watchdog.WEDGED,))
    if not res.ok:
        raise RuntimeError(f"{nproc}-process world failed after {res.attempts} "
                           f"attempt(s): outcome={res.outcome} {res.error}")
    agg = aggregate_rank_results(res.value)
    if verbose:
        print(f" {nproc}-process world: {agg['gflops_world']:.3f} GFLOP/s "
              f"(slowest-rank best), checksum {agg['checksum']:.9e} identical on all ranks")
    return agg


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
