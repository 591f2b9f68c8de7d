"""Traffic kind ``sign_loop``: the sign iteration of CP2K's linear-scaling
SCF (``LS_SCF`` with ``PURIFICATION_METHOD SIGN``) through
`dbcsr_tpu_torch.models.sign_iteration`, one SCF step a harness step.

The input is A = D + V, one block row and column of ``block`` functions
a molecule.  D is diagonal: -1 on the first ``occupied_per_molecule``
functions of each molecule, +1 on the rest.  V is symmetric and
block-sparse at the configuration's ``occupancy``, its pattern drawn
from ``pattern_seed`` with the whole block diagonal and stored in full;
its values are normal, scaled by 0.1 / sqrt(N), drawn on the device from
(seed, "A", step) and mirrored across the diagonal.  A's spectrum lies
in two bands about -1 and +1 with a gap, so sign(A) has the trace
molecules * (block - 2 * occupied_per_molecule).

Set-up builds A through the public API and runs the plain reference's
loop once on A's set-up values: the patterns of its products and its
step count give the least device time of a loop's block products
(`peaks`, beta 0, each product into an empty C).  Each step puts new
values in every block of A (`stage_device_blocks` + `finalize`), then
runs ``sign_iteration`` to convergence with the configuration's
``max_steps``, ``filter_eps`` and ``tol``, records the history's length
and last value (host floats the loop returns) and offers (step, X) to a
reservoir sample of ``check_loops`` window loops, drawn from the seed,
which keeps the window's last loop too.

The check: every window loop converged (its last history value below
``tol``); each kept loop's X against the plain reference
(``reference/sign.py``) on the same A, by pattern, values, step count
and trace.

Workload parameters: ``warm_steps``, ``check_loops`` and ``limits``.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

import dbcsr_tpu_torch as dt
from dbcsr_tpu_torch import models as dm
from portbench import inputs, peaks
from portbench.answers import output_groups
from portbench.reference import blocksparse
from portbench.reference import sign as ref
from portbench.traffic.scf_multiply import Reservoir

ENTRY = "sign"


class Inputs:
    """The cell's matrix A: its pattern from the configuration's
    ``pattern_seed``, its values drawn on the device from (seed, "A",
    step); "setup" names the values set before the warm-up."""

    def __init__(self, cfg, seed, device):
        self.seed, self.dev = seed, torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])
        n = self.n = int(cfg["molecules"])
        bs = self.block = int(cfg["block"])
        occ = int(cfg["occupied_per_molecule"])
        self.sizes = np.full(n, bs, np.int64)
        self.keys = inputs.symmetric_pattern(n, float(cfg["occupancy"]),
                                             inputs.derive(cfg["pattern_seed"], "A"))
        self.groups = inputs.shape_groups(self.keys, n, self.sizes, self.sizes)
        rows, cols = self.keys // n, self.keys % n
        self.lower = np.flatnonzero(rows > cols)
        self.mirror = np.searchsorted(self.keys, cols * n + rows)[self.lower]
        self.diag = np.flatnonzero(rows == cols)
        self.d = torch.diag(torch.tensor([-1.0] * occ + [1.0] * (bs - occ), dtype=self.dtype,
                                         device=self.dev))
        self.trace = float(n * (bs - 2 * occ))
        self.loop = {"steps": int(cfg["max_steps"]), "filter_eps": float(cfg["filter_eps"]),
                     "tol": float(cfg["tol"])}

    def values(self, step) -> torch.Tensor:
        """A's blocks of a step, (blocks, block, block) in key order."""
        ((_, idx, w),) = inputs.block_values(inputs.derive(self.seed, "A", step), self.groups,
                                             self.dtype, self.dev,
                                             scale=0.1 / math.sqrt(self.n * self.block))
        v = w.clone()
        on = lambda x: torch.from_numpy(x).to(self.dev)  # noqa: E731
        v[on(self.lower)] = w[on(self.mirror)].transpose(1, 2)
        wd = w[on(self.diag)]
        v[on(self.diag)] = torch.triu(wd) + torch.triu(wd, 1).transpose(1, 2) + self.d
        return v

    def pattern(self) -> torch.Tensor:
        p = torch.zeros(self.n * self.n, dtype=torch.bool, device=self.dev)
        p[torch.from_numpy(self.keys).to(self.dev)] = True
        return p.view(self.n, self.n)

    def dense(self, step, dtype=torch.float64) -> torch.Tensor:
        op = blocksparse.Operand(self.keys, self.sizes, self.sizes,
                                 [((self.block, self.block), np.arange(len(self.keys)),
                                   self.values(step))])
        return blocksparse.densify(op, dtype, self.dev)

    def reference(self, step, dtype=torch.float64) -> ref.SignResult:
        """The plain reference's loop on a step's A, in ``dtype``."""
        return ref.iterate(self.dense(step, dtype), self.pattern(), self.block, **self.loop)


class State:
    entry = ENTRY

    def __init__(self, run, cfg, params, seed):
        self.run, self.params = run, params
        self.inp = inp = Inputs(cfg, seed, run.device)
        least = 0.0
        for a_keys, b_keys in inp.reference("setup").multiplies:
            count = peaks.product_count(a_keys, b_keys, np.empty(0, np.int64), inp.sizes,
                                        inp.sizes, inp.sizes, 0.0, cfg["dtype"])
            least += peaks.least_time_s(count["flops"], count["bytes"], cfg["dtype"])
        self.least_s = least
        self.a = dt.create("A", inp.sizes, inp.sizes, inp.dtype, device=run.device)
        self._fill("setup")
        self.loops: dict = {}  # window step -> (history length, last value)
        self.kept = Reservoir(int(params["check_loops"]), inputs.derive(seed, "sample"))

    def _fill(self, step) -> None:
        n = self.inp.n
        self.a.stage_device_blocks(self.inp.keys // n, self.inp.keys % n,
                                   self.inp.values(step))
        self.a.finalize()

    def step(self, i: int) -> None:
        with self.run.span("refill"):
            self._fill(i)
        x, history = self.run.call(ENTRY, dm.sign_iteration, self.a, **self.inp.loop)
        if i >= 0:
            self.loops[i] = (len(history), history[-1])
            self.kept.offer((i, x))

    def release(self) -> None:
        """Drop the program's input; the kept answers stay."""
        self.a = None

    def check(self):
        limits = self.params["limits"]
        inp = self.inp
        worst = {"pattern_mismatch": 0, "rel_err": 0.0, "steps_mismatch": 0, "trace_err": 0.0}
        bad = set()
        kept = self.kept.kept()
        self.kept = None
        for i, x in kept:
            got = ref.dense_answer(output_groups(x), x.keys, inp.sizes, self.run.device)
            r = ref.judge(got, x.keys, self.loops[i][0], inp.reference(i), inp.trace)
            print(f"loop {i}: {self.loops[i][0]} steps (reference {r['steps_mismatch']} "
                  f"apart); largest difference {r['abs_diff']!r} of largest value "
                  f"{r['scale']!r}; trace off by {r['trace_err']!r}", file=sys.stderr)
            if any(r[k] > limits[k] for k in worst):
                bad.add(i)
            for k in worst:
                worst[k] = max(worst[k], r[k])
        unconverged = [i for i, (_, last) in self.loops.items()
                       if not last < inp.loop["tol"]]
        bad.update(unconverged)
        worst["unconverged_loops"] = len(unconverged)
        return ({k: (v, limits[k]) for k, v in worst.items()}, len(kept), len(bad))


def setup(run, cfg, params, seed) -> State:
    return State(run, cfg, params, seed)
