"""Analytic flop and byte model, roofline peaks, and tolerances: the
port's copy of `dbcsr_tpu/obs/costmodel.py` (it imports nothing of the
JAX package).

* **Model**: `stack_flops`/`stack_bytes` of one parameter stack (every
  entry gathers its A and B block, each C block is read and written
  once), `superstack_bytes` of one fused C-bin launch (the bin's C
  round-trip charged once), `dense_cost` of one canvas GEMM, and
  `format_costs`, the storage-format planner's cost curves.
  `core.stats` aggregates them per driver, and `obs.metrics.snapshot()`
  turns them into achieved rates and roofline fractions.
* **Peaks** per device kind (`peaks_for`, `peak_gflops`, `roofline`):
  the H100 row holds the data-sheet figures (below); the TPU and CPU
  rows are the JAX package's engineering estimates, kept so that both
  packages give the same answer for the same kind.  The overrides are
  ``DBCSR_TPU_TORCH_ROOFLINE`` (a JSON dict merged over the table) and
  the scalars ``DBCSR_TPU_TORCH_PEAK_GFLOPS`` / ``DBCSR_TPU_TORCH_PEAK_GBS``.
* **Tolerances** of the kernel checks, the ABFT probe and the demoted
  forms.

The JAX package's XLA cost capture has no counterpart (the port
compiles no XLA program).  The Cannon, mesh and gather tick models
(`cannon_tick_model`, `mesh_tick_model`, `gather_chunk_model`) give the
grid engines' modeled comm/compute balance per tick.  Stdlib-only at
import: `core.stats` imports it on the multiply's path; torch is reached
in `device_kind`.
"""

from __future__ import annotations

import json
import os


# ---------------------------------------------------------------- model
def stack_flops(m: int, n: int, k: int, entries: int) -> int:
    """True flops of one parameter stack: 2*m*n*k per entry (the
    reference's true flops, `dbcsr_mm.F:664-667`)."""
    return 2 * m * n * k * entries

# machine epsilon of the accumulation dtype (bf16 accumulates in f32;
# a complex dtype in its real part's precision)
_ACC_EPS = {
    "float64": 2.220446049250313e-16,
    "complex128": 2.220446049250313e-16,
    "float32": 1.1920929e-07,
    "complex64": 1.1920929e-07,
    "bfloat16": 1.1920929e-07,
}
# machine epsilon of each dtype's own representation (input rounding,
# and the compute dtype of a demoted stack)
_COMPUTE_EPS = {
    "float64": 2.220446049250313e-16,
    "complex128": 2.220446049250313e-16,
    "float32": 1.1920929e-07,
    "complex64": 1.1920929e-07,
    "bfloat16": 2.0 ** -8,
}


def stack_bytes(m: int, n: int, k: int, entries: int, *,
                nseg: int | None = None, itemsize: int = 8) -> int:
    """Modeled traffic of one stack when every entry fetches its A and B
    block and each of ``nseg`` C blocks is read and written once (the
    JAX package's roofline convention)."""
    if nseg is None:
        nseg = entries
    return itemsize * (entries * (m * k + k * n) + 2 * nseg * m * n)


def superstack_bytes(span_shapes, *, nseg: int, itemsize: int = 8) -> int:
    """Modeled traffic of one fused C-bin launch: every span gathers its
    own A and B blocks, but the bin's C is read and written once for the
    whole launch.  ``span_shapes`` holds (m, n, k, entries) per span,
    sharing one (m, n); equals the spans' `stack_bytes` where only the
    first passes ``nseg`` and the rest pass 0 (the convention
    `mm.multiply._run_stacks` records)."""
    gather = 0
    m = n = 0
    for m, n, k, entries in span_shapes:
        gather += entries * (m * k + k * n)
    return itemsize * (gather + 2 * nseg * m * n)


def dense_cost(m: int, n: int, k: int, *, itemsize: int = 8) -> dict:
    """Flops and bytes of one dense (m,k)x(k,n) canvas product: A and B
    read once, C written (and read, for the beta merge) once."""
    flops = 2 * m * n * k
    nbytes = itemsize * (m * k + k * n + 2 * m * n)
    return {"flops": flops, "bytes": nbytes,
            "intensity": flops / nbytes if nbytes else 0.0}


def intensity(flops: float, nbytes: float) -> float:
    """Arithmetic intensity in flops per byte."""
    return float(flops) / float(nbytes) if nbytes else 0.0


# the modeled efficiency of each format against its own roofline (the
# JAX package's prior: per-entry gathers keep the stack engine far below
# it, one large GEMM runs near it), and the dispatch cost of a launch
_FORMAT_EFF = {"stack": 0.10, "dense": 0.70, "composite": 0.55}
_DISPATCH_S = 5e-5


def format_costs(*, nbr: int, nbc: int, nbk: int, bm: int, bn: int, bk: int,
                 entries: int, nseg: int | None = None, dispatches: int = 1,
                 panels=None, dtype: str = "float64", itemsize: int = 8,
                 kind: str | None = None) -> dict:
    """Modeled seconds and GFLOP/s of one product under each storage
    format: the stack engine on its ``entries`` block products, the
    padded dense GEMM of the whole canvas, and (``panels`` the
    (groups, panel_rows, panel_kblocks) of a composite packing; None:
    composite infeasible) the composite panels.  Each leg is
    ``max(flops / peak, bytes / bandwidth) / efficiency + dispatches``
    on the `peaks_for` row of ``kind`` (the overrides apply)."""
    kind = kind or device_kind()
    peak = peak_gflops(kind, dtype) * 1e9
    bw = peaks_for(kind)["gbs"] * 1e9

    def leg(fmt: str, flops: float, nbytes: float, n_disp: int) -> dict:
        t_min = max(flops / peak if peak else 0.0, nbytes / bw if bw else 0.0)
        secs = t_min / _FORMAT_EFF[fmt] + n_disp * _DISPATCH_S
        return {"flops": int(flops), "bytes": int(nbytes), "seconds": secs,
                "gflops": flops / secs / 1e9 if secs > 0 else 0.0}

    entries = max(int(entries), 1)
    dense = dense_cost(nbr * bm, nbc * bn, nbk * bk, itemsize=itemsize)
    out = {
        "stack": leg("stack", 2.0 * bm * bn * bk * entries,
                     stack_bytes(bm, bn, bk, entries, nseg=nseg, itemsize=itemsize),
                     max(int(dispatches), 1)),
        "dense": leg("dense", dense["flops"], dense["bytes"], 1),
        "composite": None,
    }
    if panels is not None:
        groups, mp, kp = (int(panels[0]), int(panels[1]), int(panels[2]))
        n_el = nbc * bn
        c_flops = 2.0 * groups * (mp * bm) * n_el * (kp * bk)
        c_bytes = itemsize * groups * (mp * bm * kp * bk + kp * bk * n_el + 2 * mp * bm * n_el)
        out["composite"] = leg("composite", c_flops, c_bytes, 1)
    return out


def kernel_validation_tolerance(dtype: str, k: int, depth: int) -> float:
    """Relative tolerance of a kernel-vs-oracle elementwise-max check:
    an accumulation term ~eps_acc*sqrt((k+1)*(depth+1)) for a k-deep dot
    summed ``depth`` deep, plus an input-rounding term for dtypes whose
    own epsilon exceeds their accumulation epsilon (bf16)."""
    eps_acc = _ACC_EPS.get(str(dtype), 1.1920929e-07)
    eps_in = _COMPUTE_EPS.get(str(dtype), eps_acc)
    k = max(int(k), 1)
    depth = max(int(depth), 1)
    return max(2.0 * eps_acc * float((k + 1) * (depth + 1)) ** 0.5,
               4.0 * eps_in * float(k + 1) ** 0.5)


def form_tolerance(dtype: str, precision, k: int, depth: int) -> float:
    """Relative tolerance of a kernel form against its own plain version
    or oracle: ``precision`` None is the native form; a demoted form
    rounds the same operands in both, so only the order of the sums
    differs.  A compensated form sums its products in the data's dtype;
    an uncompensated one sums each k-deep product in float32 and the
    run in the data's dtype."""
    if precision is None or precision[1]:
        return kernel_validation_tolerance(dtype, k, depth)
    return max(kernel_validation_tolerance("float32", k, depth if dtype == "float32" else 1),
               kernel_validation_tolerance(dtype, k, depth))


def abft_tolerance(dtype: str, k: int, depth: int) -> float:
    """Relative tolerance of an ABFT probe comparison (`acc/abft.py`):
    ``C·v`` against ``A·(B·v)`` is one bilinear form summed in two
    orders, so they differ by rounding only, bounded by the
    accumulation epsilon times the reduction lengths (``k`` terms per
    product, ``depth`` accumulated per C block) with the JAX package's
    margin (`dbcsr_tpu/obs/costmodel.py:200-213`)."""
    eps = _ACC_EPS.get(str(dtype), 1.1920929e-07)
    k = max(int(k), 1)
    depth = max(int(depth), 1)
    return 64.0 * eps * (k + 1) * float(depth + 1) ** 0.5


def effective_epsilon(compute: str, compensated: bool) -> float:
    """Per-product relative rounding of a demoted compute scheme
    (`acc/precision.py`): the compute dtype's epsilon, or, with the
    two-product compensation (hi/lo splits restoring every cross term
    but lo*lo), its square with a x4 margin for the recombination's
    roundings (`dbcsr_tpu/obs/costmodel.py:189`)."""
    eps = _COMPUTE_EPS.get(str(compute), 2.0 ** -8)
    return 4.0 * eps * eps if compensated else eps


def demoted_abft_tolerance(dtype: str, compute: str, compensated: bool,
                           k: int, depth: int) -> float:
    """The probe ceiling of a launch run at a demoted compute dtype
    (`dbcsr_tpu/obs/costmodel.py:216`): the effective epsilon with the
    native tolerance's x64 margin (the probe's scale already bounds the
    sum of |terms|), plus, for the uncompensated form, which sums each
    k-deep block product in the compute family's narrow accumulator
    (float32), a k-deep term; never tighter than the native tolerance."""
    tol = 64.0 * effective_epsilon(compute, compensated)
    if not compensated:
        tol += 8.0 * _ACC_EPS.get(str(compute), 1.1920929e-07) * max(int(k), 1)
    return max(tol, abft_tolerance(dtype, k, depth))


# ------------------------------------------------------- roofline table
# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit:
# HBM3 bandwidth, and the peak for each operand type (f64: FP64 tensor
# cores; f32: CUDA cores; bf16: tensor cores); a complex type runs on
# its real part's units
H100_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12,
                   "complex128": 67e12, "complex64": 67e12}
_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "complex128": 16, "complex64": 8}
# real operations per multiply-add: a complex one is 4 real multiply-adds
# (`dbcsr_tpu/obs/costmodel.py:peak_gflops`, :358-370)
_MAC_OPS = {"complex128": 8, "complex64": 8}


def stack_min_bytes(dtype: str, m: int, n: int, k: int, entries: int,
                    n_a: int, n_b: int, nruns: int) -> int:
    """Bytes one stack must move: each of the ``n_a`` A and ``n_b`` B
    blocks it references read once, its index arrays read once, each of
    the ``nruns`` C blocks read and written once."""
    return (_ITEMSIZE[dtype] * (n_a * m * k + n_b * k * n + 2 * nruns * m * n)
            + 4 * (2 * entries + 2 * nruns + 1))


def stack_bound_s(dtype: str, m: int, n: int, k: int, entries: int,
                  n_a: int, n_b: int, nruns: int, precision=None) -> tuple:
    """Least time one stack can take on an H100, and what bounds it
    ("bytes" or "operations"): the larger of `stack_min_bytes` over the
    memory rate and its real operations over the type's peak (a complex
    multiply-add counts 8).  The same for every stack kernel, since they
    compute the same function.  A demoted ``precision`` spec moves the
    same bytes and does its operations at the compute dtype's peak, three
    products each when compensated."""
    t_bytes = stack_min_bytes(dtype, m, n, k, entries, n_a, n_b, nruns) / H100_BYTES_PER_S
    ops = _MAC_OPS.get(dtype, 2) * float(m) * n * k * entries
    if precision is None:
        t_ops = ops / H100_PEAK_FLOPS[dtype]
    else:
        t_ops = ops * (3 if precision[1] else 1) / H100_PEAK_FLOPS[precision[0]]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def crosspack_entries(plan) -> int:
    """Entry slots a crosspack plan's kernel walks, idle lanes included:
    each pack's P lanes for as many entries as the pack's longest run
    (the counterpart of the JAX package's `crosspack_launch_entries`,
    whose slots are the packed steps with their padding)."""
    return int(plan.pack[0] * plan.pack_longest.sum())


# Peaks per device kind, matched by lowercase substring of the device's
# name ("NVIDIA H100 80GB HBM3" -> "h100"): "gflops" per dtype, "gbs" the
# device memory's bandwidth, "ici_gbs" the interconnect's.  The H100 row
# is the data sheet's (above; NVLink 450 GB/s each way); the TPU and CPU
# rows are the JAX package's estimates, kept so that both packages give
# the same answer for the same kind.
_PEAKS: dict = {
    "h100": {"gflops": {d: H100_PEAK_FLOPS[d] / 1e9
                        for d in ("bfloat16", "float32", "float64")},
             "gbs": H100_BYTES_PER_S / 1e9, "ici_gbs": 450.0},
    "tpu v6": {"gflops": {"bfloat16": 918000.0, "float32": 229000.0, "float64": 7000.0},
               "gbs": 1640.0, "ici_gbs": 448.0},
    "tpu v5p": {"gflops": {"bfloat16": 459000.0, "float32": 115000.0, "float64": 5000.0},
                "gbs": 2765.0, "ici_gbs": 600.0},
    "tpu v5 lite": {"gflops": {"bfloat16": 197000.0, "float32": 49000.0, "float64": 3000.0},
                    "gbs": 819.0, "ici_gbs": 200.0},
    "tpu v4": {"gflops": {"bfloat16": 275000.0, "float32": 69000.0, "float64": 4000.0},
               "gbs": 1228.0, "ici_gbs": 300.0},
    "cpu": {"gflops": {"bfloat16": 100.0, "float32": 100.0, "float64": 50.0},
            "gbs": 20.0, "ici_gbs": 20.0},
}
_DEFAULT_PEAK = {"gflops": {"float64": 100.0, "float32": 200.0, "bfloat16": 200.0},
                 "gbs": 100.0, "ici_gbs": 100.0}

_env_table = None  # DBCSR_TPU_TORCH_ROOFLINE, parsed once
_kind = None  # the default device's name, read once


def _env_overrides() -> dict:
    global _env_table
    if _env_table is None:
        raw = os.environ.get("DBCSR_TPU_TORCH_ROOFLINE", "")
        try:
            _env_table = json.loads(raw) if raw else {}
        except ValueError:
            _env_table = {}
    return _env_table


def device_kind() -> str:
    """The default device's kind: `torch.cuda.get_device_name(0)` where
    CUDA is available, else "cpu"."""
    global _kind
    if _kind is None:
        import torch

        _kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    return _kind


def peaks_for(kind: str | None = None) -> dict:
    """The peak row of a device kind: the longest matching key of the
    table with the overrides folded in; an unknown kind gets the
    conservative default row."""
    kind = (kind or device_kind()).lower()
    table = dict(_PEAKS)
    for key, row in _env_overrides().items():
        base = dict(table.get(key.lower(), _DEFAULT_PEAK))
        gf = dict(base.get("gflops", {}))
        gf.update(row.get("gflops", {}))
        base.update(row)
        base["gflops"] = gf
        table[key.lower()] = base
    best = None
    for key, row in table.items():
        if key in kind and (best is None or len(key) > len(best[0])):
            best = (key, row)
    entry = dict(best[1]) if best else dict(_DEFAULT_PEAK)
    env_gf = os.environ.get("DBCSR_TPU_TORCH_PEAK_GFLOPS")
    if env_gf:
        entry["gflops"] = {d: float(env_gf) for d in
                           set(entry["gflops"]) | {"float64", "float32"}}
    env_bw = os.environ.get("DBCSR_TPU_TORCH_PEAK_GBS")
    if env_bw:
        entry["gbs"] = float(env_bw)
    return entry


def peak_gflops(kind: str | None = None, dtype: str = "float64") -> float:
    """Peak compute of a dtype on a device kind.  A complex dtype takes
    its real part's peak over 4 (a complex multiply-add is 4 real ones,
    and the engine counts 2*m*n*k flops whatever the dtype)."""
    gf = peaks_for(kind)["gflops"]
    dtype = str(dtype)
    if dtype in gf:
        return float(gf[dtype])
    if dtype == "complex64":
        return float(gf.get("float32", _DEFAULT_PEAK["gflops"]["float32"])) / 4
    if dtype == "complex128":
        return float(gf.get("float64", _DEFAULT_PEAK["gflops"]["float64"])) / 4
    if dtype == "float16":
        return float(gf.get("bfloat16", gf.get("float32", 100.0)))
    return float(gf.get("float32", _DEFAULT_PEAK["gflops"]["float32"]))


def roofline(flops: float, nbytes: float, seconds: float,
             kind: str | None = None, dtype: str = "float64") -> dict:
    """Roofline attribution of one measured region: achieved GFLOP/s,
    arithmetic intensity, the attainable rate at that intensity
    (``min(peak compute, intensity * bandwidth)``) and the achieved
    fraction of it."""
    kind = kind or device_kind()
    entry = peaks_for(kind)
    peak = peak_gflops(kind, dtype)
    inten = intensity(flops, nbytes)
    attainable = min(peak, inten * entry["gbs"]) if nbytes else peak
    achieved = flops / seconds / 1e9 if seconds > 0 else 0.0
    return {
        "device_kind": kind,
        "dtype": str(dtype),
        "achieved_gflops": achieved,
        "arithmetic_intensity": inten,
        "peak_gflops": peak,
        "peak_gbs": entry["gbs"],
        "attainable_gflops": attainable,
        "roofline_fraction": achieved / attainable if attainable else 0.0,
        "bytes_moved": int(nbytes),
        "flops": int(flops),
        "seconds": seconds,
    }


# ------------------------------------------------------ grid tick models
def _tick_balance(flops: float, comm_bytes: float, dtype: str, kind: str | None) -> dict:
    """Comm/compute balance of one metronome tick against the peaks:
    ``overlap_ratio`` = modeled comm time / compute time; below 1.0 the
    shift hides behind the local products (the comm-thread overlap the
    reference gets from USE_COMM_THREAD)."""
    kind = kind or device_kind()
    peak = peak_gflops(kind, dtype) * 1e9
    ici = peaks_for(kind)["ici_gbs"] * 1e9
    t_comp = flops / peak if peak else 0.0
    t_comm = comm_bytes / ici if ici else 0.0
    return {"tick_flops": int(flops), "tick_comm_bytes": int(comm_bytes),
            "t_compute_s": t_comp, "t_comm_s": t_comm,
            "overlap_ratio": (t_comm / t_comp) if t_comp > 0 else 0.0}


def cannon_tick_model(m: int, n: int, k: int, kl: int, s: int, itemsize: int, dtype: str,
                      kind: str | None = None) -> dict:
    """Per-image, per-tick balance of the dense Cannon: each tick
    contracts a local (m/s, k/(kl*s)) x (k/(kl*s), n/s) panel pair while
    both operand panels shift."""
    m_loc, n_loc, k_loc = m / s, n / s, k / (kl * s)
    flops = 2.0 * m_loc * n_loc * k_loc
    comm_bytes = (m_loc * k_loc + k_loc * n_loc) * itemsize
    return _tick_balance(flops, comm_bytes, dtype, kind)


def mesh_tick_model(cap_a: int, cap_b: int, bm: int, bk: int, bn: int, entries: int,
                    nticks: int, ndev: int, itemsize: int, dtype: str,
                    kind: str | None = None) -> dict:
    """Per-image, per-tick balance of the block-sparse Cannon: each tick
    shifts a full padded A panel (``cap_a`` blocks of (bm, bk)) and B
    panel (``cap_b`` of (bk, bn)) while contracting this tick's share of
    the product's ``entries`` (split evenly over images x ticks)."""
    flops = 2.0 * bm * bn * bk * entries / max(ndev * nticks, 1)
    comm_bytes = (cap_a * bm * bk + cap_b * bk * bn) * itemsize
    return _tick_balance(flops, comm_bytes, dtype, kind)


def gather_chunk_model(cap_a: int, cap_b: int, bm: int, bk: int, bn: int, entries: int,
                       nticks: int, ndev: int, itemsize: int, dtype: str,
                       kind: str | None = None) -> dict:
    """Per-image, per-chunk balance of the chunked all-gather pipeline on
    rectangular grids: each of the ``nticks`` steps moves one padded A
    shard and one B shard while the tick contracts its shard-arrival
    share of the ``entries`` (`mesh_tick_model`'s balance on the gather
    schedule, one gauge family for both routes)."""
    return mesh_tick_model(cap_a, cap_b, bm, bk, bn, entries, nticks, ndev, itemsize, dtype,
                           kind)
