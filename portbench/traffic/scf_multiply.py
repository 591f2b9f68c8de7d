"""Traffic kind ``scf_multiply``: an SCF loop's repeated product of one
block pattern through `dbcsr_tpu_torch.multiply`.

Set-up draws the configuration's patterns of A, B and C0 (from its
``pattern_seed``) and C0's values (from the run's seed), and builds the
three matrices through the public API.  Each step sets new values in
every block of A and B, drawn on the device from (seed, operand, step)
and staged through `stage_device_blocks` + `finalize`, so the program's
mutation journal knows they changed; then copies C0 and multiplies into
the copy: C = alpha * A @ B + beta * C0, as the ``.perf`` driver's
repeats do.

The check keeps the answers of a reservoir sample of ``check_steps``
window steps, drawn from the seed, and of the window's last step, and
holds each against the plain reference: its pattern key for key, its
values by the largest difference over the largest reference value.

Workload parameters: ``warm_steps``, ``check_steps`` and ``limits``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import dbcsr_tpu_torch as dt
from portbench import inputs, peaks
from portbench.answers import output_groups
from portbench.reference import blocksparse as ref

ENTRY = "multiply"


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, the
    choices drawn from ``seed``; the stream's last item is kept too."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng(seed)
        self.items, self.last, self.seen = [], None, 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1
        self.last = item

    def kept(self) -> list:
        out = list(self.items)
        if self.last is not None and all(x is not self.last for x in out):
            out.append(self.last)
        return out


class Inputs:
    """The cell's operands: patterns from the configuration's
    ``pattern_seed``, values drawn on the device from (seed, operand,
    step); "setup" names the values set before the warm-up."""

    def __init__(self, cfg, seed, device):
        self.seed, self.dev = seed, device
        self.dtype = getattr(torch, cfg["dtype"])
        self.alpha, self.beta = float(cfg["alpha"]), float(cfg["beta"])
        self.sizes = inputs.block_sizes(cfg["blocks"])
        n = self.n = len(self.sizes)
        occ, ps = cfg["occupancy"], cfg["pattern_seed"]
        self.keys = {x: inputs.random_pattern(n, n, float(occ[x]), inputs.derive(ps, x))
                     for x in ("A", "B", "C")}
        self.groups = {x: inputs.shape_groups(k, n, self.sizes, self.sizes)
                       for x, k in self.keys.items()}
        count = peaks.product_count(self.keys["A"], self.keys["B"], self.keys["C"], self.sizes,
                                    self.sizes, self.sizes, self.beta, cfg["dtype"])
        self.least_s = peaks.least_time_s(count["flops"], count["bytes"], cfg["dtype"])

    def values(self, x, step):
        return inputs.block_values(inputs.derive(self.seed, x, step), self.groups[x],
                                   self.dtype, self.dev)

    def operand(self, x, step) -> ref.Operand:
        return ref.Operand(self.keys[x], self.sizes, self.sizes, self.values(x, step))

    def operands(self, step):
        """(A, B, C0, alpha, beta) of a step, as the reference takes them."""
        return (self.operand("A", step), self.operand("B", step), self.operand("C", "setup"),
                self.alpha, self.beta)


class State:
    entry = ENTRY

    def __init__(self, run, cfg, params, seed):
        self.run, self.params = run, params
        self.inp = inp = Inputs(cfg, seed, run.device)
        self.least_s = inp.least_s
        self.a, self.b, self.c0 = (dt.create(x, inp.sizes, inp.sizes, inp.dtype,
                                             device=run.device) for x in ("A", "B", "C0"))
        self._fill(self.c0, "C", "setup")
        self._fill(self.a, "A", "setup")
        self._fill(self.b, "B", "setup")
        self.kept = Reservoir(int(params["check_steps"]), inputs.derive(seed, "sample"))

    def _fill(self, m, x, step) -> None:
        n = self.inp.n
        for _, idx, vals in self.inp.values(x, step):
            k = self.inp.keys[x][idx]
            m.stage_device_blocks(k // n, k % n, vals)
        m.finalize()

    def step(self, i: int) -> None:
        with self.run.span("refill"):
            self._fill(self.a, "A", i)
            self._fill(self.b, "B", i)
            c = self.c0.copy()
        self.run.call(ENTRY, dt.multiply, "N", "N", self.inp.alpha, self.a, self.b,
                      self.inp.beta, c)
        if i >= 0:
            self.kept.offer((i, c))

    def release(self) -> None:
        """Drop the program's operands; the kept answers stay."""
        self.a = self.b = self.c0 = None

    def check(self):
        limits = self.params["limits"]
        worst = {"pattern_mismatch": 0, "rel_err": 0.0}
        failed = 0
        kept = self.kept.kept()
        self.kept = None
        for i, c in kept:
            r = ref.compare(output_groups(c), c.keys, *self.inp.operands(i), self.run.device)
            print(f"step {i}: largest difference {r['abs_diff']!r} of largest value "
                  f"{r['scale']!r}; {r['differ']} values differ", file=sys.stderr)
            failed += any(r[k] > limits[k] for k in worst)
            for k in worst:
                worst[k] = max(worst[k], r[k])
        return ({k: (v, limits[k]) for k, v in worst.items()}, len(kept), failed)


def setup(run, cfg, params, seed) -> State:
    return State(run, cfg, params, seed)
