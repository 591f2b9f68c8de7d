"""Kernel autotuner.

Counterpart of `dbcsr_tpu/acc/tune.py` (ref `src/acc/libsmm_acc/tune/`,
tune_setup/submit/collect/merge collapsed into one loop): for one
(m, n, k, dtype), time every candidate launch of the stack on one
synthetic stack and write the winner into the device kind's parameter
table (`acc/params.py`), which dispatch consults.

The candidates on CUDA tensors are the hand-written kernels only: K1
(`stack_kernel.smm_stack`), K3 (`crosspack_kernel.smm_crosspack`) at
each legal pack (P, R) of the JAX package's set, K4 (its resident
launch) where `crosspack.supports_resident` admits the operands, and
K1's demoted forms for the ``precision`` column (float64: "f32c",
"f32"; float32: "bf16").  The plain PyTorch version ("torch") and the
native host driver ("host") are candidates for CPU tensors only, so no
row can send a stack on the card to the plain version.  The JAX
package's R-grouping candidates (`xla_group`, ``pallas R=...``) have no
counterpart: the port has no R grouping, and K2 (kmerge) is K1.

Every candidate is checked once, on its first run, against the plain
version of its form on the same inputs, within
`obs.costmodel.form_tolerance` (for a native form,
`kernel_validation_tolerance`).  A candidate the kernel's own shape
rules refuse (a pack with P <= 1, K4 not admitted) is not timed and its
line says why; one that raises or fails its check prints its error and
counts in the returned entry's ``errors``.  Rows carry ``"env"``: the
device they were measured on ("cuda" or "cpu").

CLI:

    python -m dbcsr_tpu_torch.acc.tune M N K [dtype_enum] [stack_size] [nrep]
    python -m dbcsr_tpu_torch.acc.tune --table [nrep]

``--table`` tunes every row of `table_rows` (the shapes the smoke's
workloads launch) into the card's table; ``DBCSR_TPU_TORCH_PARAMS_DIR``
redirects it.
"""

from __future__ import annotations

import itertools
import sys
import time

import numpy as np
import torch

from dbcsr_tpu_torch.acc import params as params_mod
from dbcsr_tpu_torch.core.kinds import dtype_of, host_dtype, name_of
from dbcsr_tpu_torch.device import resolve_device

# demoted forms of K1 timed for the ``precision`` column, by data dtype
# (the JAX package's set, `dbcsr_tpu/acc/tune.py:173-189`)
_DEMOTED = {torch.float64: ("f32c", "f32"), torch.float32: ("bf16",)}

# entries of the (23, 23, 23) span of the north star's product
# (`tests/inputs/northstar.perf`; the span that chip_smoke.py's northstar
# line reports), so that `params.lookup`'s nearest-size rule has a row at
# the north star's own size beside the 30000-entry one
NORTHSTAR_SPAN = 825573


def table_rows() -> list:
    """(m, n, k, dtype_enum, stack_size) of every row of the committed
    table: the shapes the smoke's workloads launch at float64 and
    float32 -- the north star's {18, 23}^3 (its last block is 18),
    `mixed_blocks`' {5, 13, 21, 23}^3 (its last block is 21), the RI
    contraction's (529, 23, 23), the JAX package's TPU table's 4^3, 32^3
    and 64^3 -- at 30000 entries, 23^3 also at the north star's span
    size, and 23^3 at bfloat16."""
    rows = []
    for dt in (3, 1):
        shapes = set(itertools.product((5, 13, 21, 23), repeat=3))
        shapes |= set(itertools.product((18, 23), repeat=3))
        shapes |= {(529, 23, 23), (4, 4, 4), (32, 32, 32), (64, 64, 64)}
        rows += [(*mnk, dt, 30000) for mnk in sorted(shapes)]
        if NORTHSTAR_SPAN:
            rows.append((23, 23, 23, dt, NORTHSTAR_SPAN))
    rows.append((23, 23, 23, 9, 30000))
    return rows


def _measure_env(device: torch.device) -> str:
    """Where a row was measured: "cuda" on the card, "cpu" otherwise.
    No lookup reads it (the port has no provenance rule)."""
    return "cuda" if device.type == "cuda" else "cpu"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_config(fn, nrep: int, device: torch.device, check=None) -> float:
    """Best seconds of ``fn`` over ``nrep`` runs, each fenced by a
    synchronize; the warm-up run's result goes to ``check`` first."""
    out = fn()
    _sync(device)
    if check is not None:
        check(out)
    best = float("inf")
    for _ in range(nrep):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def candidate_set(m: int, n: int, k: int, dtype, on_card: bool, resident: bool):
    """(candidates, refused) of one shape: each candidate a ``(tag, row,
    how)`` triple -- its line's tag, its table row's fields, and what
    `_plan` makes of it (``variant``, ``pack``, ``precision``,
    ``driver``, ``kernel``) -- and each refusal a ``(tag, reason)``
    pair.  ``on_card`` keeps the plain version and the host driver
    out; ``resident`` is the K4 gate's answer for the operands."""
    from dbcsr_tpu_torch import native
    from dbcsr_tpu_torch.acc import precision
    from dbcsr_tpu_torch.acc.crosspack import choose_pack

    dtype = dtype_of(dtype)
    cands, refused = [], []
    if not on_card:
        cands.append(("torch", {"driver": "torch", "grouping": None},
                      {"driver": "torch", "kernel": "plain"}))
        if native.host_smm_supports(dtype):
            cands.append(("host", {"driver": "host", "grouping": None},
                          {"driver": "host", "kernel": "host_smm"}))
    cands.append(("K1", {"driver": "pallas", "grouping": None},
                  {"variant": "kmerge", "kernel": "smm_stack"}))
    for col in _DEMOTED.get(dtype, ()):
        spec = precision.column_spec(col, dtype)
        cands.append((f"K1 {col}", {"driver": "pallas", "grouping": None, "precision": col},
                      {"variant": "kmerge", "precision": spec, "kernel": "smm_stack"}))
    if dtype.is_complex:
        refused.append(("K3/K4", "the crosspack kernel takes no complex stack"))
        return cands, refused
    # the JAX package's packs around the geometric default, clamped to
    # what dispatch runs from a tuned row (`acc/smm.py:_crosspack_choice`)
    p0, r0 = choose_pack(m, n, k)
    pmax = max(1, min(8, 128 // max(m, n)))
    rmax = max(1, min(8, 128 // k))
    packs = {(p0, r0), (pmax, rmax), (p0, max(1, r0 // 2)), (max(2, p0 // 2), r0)}
    for P, R in sorted(packs):
        if P > pmax or R > rmax:
            refused.append((f"K3 P={P} R={R}", f"beyond the 128 bound (P <= {pmax}, R <= {rmax})"))
            continue
        if P <= 1:
            refused.append((f"K3 P={P} R={R}", "P <= 1: the stack takes K1"))
            continue
        for vname, tag, kernel in (("crosspack", "K3", "smm_crosspack"),
                                   ("crosspack_vmem", "K4", "smm_crosspack_resident")):
            if vname == "crosspack_vmem" and not resident:
                refused.append((f"{tag} P={P} R={R}",
                                "operands exceed the persisting-L2 limit"))
                continue
            cands.append((f"{tag} P={P} R={R}",
                          {"driver": "pallas", "variant": vname, "grouping": R, "pack_p": P},
                          {"variant": vname, "pack": (P, R), "kernel": kernel}))
    return cands, refused


def _plan(how: dict, c, a, b, ai, bi, ci):
    """The stack planned for one candidate, as dispatch plans it, with no
    fallback: a plan of another kernel than the candidate's raises."""
    from dbcsr_tpu_torch.acc import smm

    plan = smm._prepare_stack_impl(c, a, b, ai, bi, ci, variant=how.get("variant"),
                                   pack=how.get("pack"), driver=how.get("driver"))
    plan.precision = how.get("precision")
    if plan.kernel != how["kernel"]:
        raise RuntimeError(f"planned {plan.kernel}, not {how['kernel']}")
    return plan


class _Candidates(list):
    """Candidate list that persists the best row after every append, so a
    later candidate that ends the process loses no timing already taken
    (the sweep's resumability).  With ``persist=False`` nothing is
    written; ``mirror`` receives each candidate with its check."""

    def __init__(self, m, n, k, dtype, stack_size, out, env, persist=True, mirror=None):
        super().__init__()
        self._row = {"m": m, "n": n, "k": k, "dtype": name_of(dtype),
                     "stack_size": stack_size, "env": env}
        self._out = out
        self._best = None
        self._persist = persist
        self._mirror = mirror

    def append(self, cand, check=None) -> None:
        super().append(cand)
        if self._mirror is not None:
            self._mirror.append({**cand, **(check or {})})
        if self._best is None or cand["gflops"] > self._best:
            self._best = cand["gflops"]
            if not self._persist:
                return
            try:
                params_mod.save_entry({**self._row, **cand, "gflops": round(cand["gflops"], 2)})
            except OSError as exc:
                self._out(f"  (best-so-far persist failed: {exc})")


def tune_smm(m: int, n: int, k: int, dtype_enum: int = 1, stack_size: int = 30000,
             nrep: int = 3, out=print, seed: int = 7, persist: bool = True,
             candidates_out=None, device=None) -> dict:
    """Tune one (m, n, k, dtype) on ``device`` (the card unless the
    caller asks for the CPU); returns the best entry and, with
    ``persist``, saves it into the device kind's table.  The entry
    carries ``errors`` (candidates that raised or failed their check,
    listed in ``failures``) and ``refused`` (candidates the kernels'
    shape rules refused, with why).  ``persist=False`` runs the same
    sweep without touching the table; ``candidates_out``, a list,
    receives every timed candidate with its check against the plain
    version (``max_rel_err``, ``tol``)."""
    from dbcsr_tpu_torch.acc import stack_kernel
    from dbcsr_tpu_torch.acc.crosspack import runs, supports_resident
    from dbcsr_tpu_torch.acc.smm import _execute_plan
    from dbcsr_tpu_torch.obs.costmodel import form_tolerance, stack_flops

    dev = resolve_device(device)
    dtype = dtype_of(dtype_enum)
    dname = name_of(dtype)
    rng = np.random.default_rng(seed)
    na = nb = max(stack_size // 16, 2)
    nc = max(stack_size // 8, 1)
    hdt = host_dtype(dtype)
    a = torch.from_numpy(rng.standard_normal((na, m, k)).astype(hdt)).to(dev, dtype)
    b = torch.from_numpy(rng.standard_normal((nb, k, n)).astype(hdt)).to(dev, dtype)
    ai = rng.integers(0, na - 1, stack_size).astype(np.int32)
    bi = rng.integers(0, nb - 1, stack_size).astype(np.int32)
    ci = np.sort(rng.integers(0, nc, stack_size)).astype(np.int32)
    run_ptr, run_c = runs(ci)
    depth = int(np.diff(run_ptr).max())
    flops = stack_flops(m, n, k, stack_size)
    env = _measure_env(dev)
    candidates = _Candidates(m, n, k, dtype, stack_size, out, env, persist=persist,
                             mirror=candidates_out)
    c = torch.zeros((nc, m, n), dtype=dtype, device=dev)
    index = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
             for x in (ai, bi, run_ptr, run_c)]
    refs: dict = {}

    def reference(spec):
        # the plain version of the form, once per form
        if spec not in refs:
            ref = torch.zeros_like(c)
            stack_kernel.smm_stack_plain(ref, a, b, *index, 1.0, precision=spec)
            refs[spec] = ref.double()
        return refs[spec]

    cands, refused = candidate_set(m, n, k, dtype, on_card=dev.type == "cuda",
                                   resident=supports_resident(a, b))
    for tag, why in refused:
        out(f"  {tag}: not timed ({why})")
    failures = []
    for tag, row, how in cands:
        check = {}

        def held(got, spec=how.get("precision"), check=check):
            want = reference(spec)
            err = float((got.double() - want).abs().max()) / max(float(want.abs().max()), 1.0)
            tol = form_tolerance(dname, spec, k, depth)
            check.update(max_rel_err=err, tol=tol)
            if not err <= tol:
                raise AssertionError(f"relative error {err:.3e} > {tol:.1e} against "
                                     f"the plain version")

        try:
            plan = _plan(how, c, a, b, ai, bi, ci)

            def run(plan=plan):
                c.zero_()
                return _execute_plan(c, a, b, plan, 1.0)

            t = _time_config(run, nrep, dev, check=held)
        except Exception as exc:  # noqa: BLE001 -- reported, counted, never skipped
            failures.append({"candidate": tag, "error": f"{type(exc).__name__}: {exc}"[:300]})
            out(f"  {tag}: failed ({type(exc).__name__}: {exc})")
            continue
        candidates.append({**row, "kernel": how["kernel"], "gflops": flops / t / 1e9},
                          check=dict(check, candidate=tag))
        out(f"  {tag}: {flops / t / 1e9:.1f} GFLOP/s (max rel err {check['max_rel_err']:.2e}"
            f" <= {check['tol']:.1e})")
    if not candidates:
        raise RuntimeError(f"tune {m}x{n}x{k} {dname}: every candidate failed: {failures}")
    best = max(candidates, key=lambda cand: cand["gflops"])
    row = {"m": m, "n": n, "k": k, "dtype": dname, "stack_size": stack_size, "env": env,
           **best, "gflops": round(best["gflops"], 2)}
    if persist:
        path = params_mod.save_entry(row)
        out(f"best: {row['kernel']} {row['gflops']} GFLOP/s -> {path}")
    else:
        out(f"best (trial, not persisted): {row['kernel']} {row['gflops']} GFLOP/s")
    return {**row, "errors": len(failures), "failures": failures,
            "refused": [{"candidate": t, "why": w} for t, w in refused]}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--table":
        nrep = int(argv[1]) if len(argv) > 1 and int(argv[1]) else 3
        errors = 0
        for m, n, k, dt, s in table_rows():
            print(f"tune {m}x{n}x{k} dtype {dt} stack {s}", flush=True)
            errors += tune_smm(m, n, k, dt, s, nrep)["errors"]
        return 1 if errors else 0
    if len(argv) < 3:
        print(__doc__)
        return 1
    m, n, k = (int(x) for x in argv[:3])
    dtype_enum = int(argv[3]) if len(argv) > 3 and int(argv[3]) else 1
    stack_size = int(argv[4]) if len(argv) > 4 and int(argv[4]) else 30000
    nrep = int(argv[5]) if len(argv) > 5 and int(argv[5]) else 3
    return 1 if tune_smm(m, n, k, dtype_enum, stack_size, nrep)["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
