"""Traffic kind ``scf_contract``: RI-HFX's per-SCF-step contraction
C(mu,nu,Q) = sum_P T(mu,nu,P) M(P,Q) through
`dbcsr_tpu_torch.tensor.contract`, T fixed and M new at every step.

M has a density's pattern: symmetric, the whole diagonal, the
configuration's occupancy (from its ``pattern_seed``).  T holds the
block (mu, nu, P) wherever M's pattern has (mu, nu) and (mu, P).  T is
mapped rows (mu, nu), columns P, as (529, 23) matrix blocks drawn on the
device from the run's seed in one call.  Each step draws M's values
anew from (seed, "M", step), 0.5 on the diagonal plus normals scaled by
0.1 / sqrt(N), stages them through the public API, and contracts into a
fresh empty C mapped rows (mu, nu), columns Q, with alpha 1 and beta 0.

The check holds the last step's C against the plain reference in full
(pattern key for key, values by the largest difference over the largest
reference value), and every step's C by its norm: each step's norm is
read on the device right after its contraction (``digest`` span) and
held against the reference's norm of that step.

Workload parameters: ``warm_steps`` and ``limits``.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from dbcsr_tpu_torch import tensor as dtt
from portbench import inputs, peaks
from portbench.answers import output_groups
from portbench.reference import blocksparse as ref

ENTRY = "contract"
RI_KW = dict(contract_a=(2,), notcontract_a=(0, 1), contract_b=(0,), notcontract_b=(1,),
             map_1=(0, 1), map_2=(2,))


def _wide(t):
    return torch.complex128 if t.is_complex() else torch.float64


class Inputs:
    """The cell's operands: M's pattern from the configuration's
    ``pattern_seed`` and T's from M's; values drawn on the device from
    (seed, operand, step); "setup" names the values set before the
    warm-up (T's for good)."""

    def __init__(self, cfg, seed, device):
        self.seed, self.dev = seed, device
        self.dtype = getattr(torch, cfg["dtype"])
        n = self.n = int(cfg["molecules"])
        blk = int(cfg["block"])
        self.dims = [[blk] * n] * 3
        d_keys = inputs.symmetric_pattern(n, float(cfg["occupancy"]),
                                          inputs.derive(cfg["pattern_seed"], "density"))
        per_row = np.split(d_keys % n, np.searchsorted(d_keys // n, np.arange(1, n)))
        # T's matrix blocks: row (mu, nu) = mu * n + nu, column P
        t_keys = np.concatenate([((mu * n + np.repeat(s, len(s))) * n + np.tile(s, len(s)))
                                 for mu, s in enumerate(per_row)]).astype(np.int64)
        self.row_sizes = np.full(n * n, blk * blk, np.int64)
        self.k_sizes = np.full(n, blk, np.int64)
        self.keys = {"T": t_keys, "M": d_keys}
        self.groups = {"T": inputs.shape_groups(t_keys, n, self.row_sizes, self.k_sizes),
                       "M": inputs.shape_groups(d_keys, n, self.k_sizes, self.k_sizes)}
        self.m_scale = 0.1 / math.sqrt(n * blk)
        count = peaks.product_count(t_keys, d_keys, np.empty(0, np.int64), self.row_sizes,
                                    self.k_sizes, self.k_sizes, 0.0, cfg["dtype"])
        self.least_s = peaks.least_time_s(count["flops"], count["bytes"], cfg["dtype"])

    def values(self, x, step):
        if x == "T":
            return inputs.block_values(inputs.derive(self.seed, "T", step), self.groups["T"],
                                       self.dtype, self.dev)
        return inputs.block_values(inputs.derive(self.seed, "M", step), self.groups["M"],
                                   self.dtype, self.dev, scale=self.m_scale, diag_shift=0.5,
                                   keys=self.keys["M"], ncols=self.n)

    def operand(self, x, step) -> ref.Operand:
        rows = self.row_sizes if x == "T" else self.k_sizes
        return ref.Operand(self.keys[x], rows, self.k_sizes, self.values(x, step))

    def operands(self, step, t_op=None):
        """(T, M, empty C0, alpha 1, beta 0) of a step, as the reference
        takes them (``t_op``: T's operand, drawn once for many steps)."""
        empty = ref.Operand(np.empty(0, np.int64), self.row_sizes, self.k_sizes, [])
        return (t_op or self.operand("T", "setup"), self.operand("M", step), empty, 1.0, 0.0)


class State:
    entry = ENTRY

    def __init__(self, run, cfg, params, seed):
        self.run, self.params = run, params
        self.inp = inp = Inputs(cfg, seed, run.device)
        self.least_s = inp.least_s
        n = inp.n
        self.t = dtt.create_tensor("T", inp.dims, (0, 1), (2,), dtype=inp.dtype,
                                   device=run.device)
        for _, idx, vals in inp.values("T", "setup"):
            k = inp.keys["T"][idx]
            self.t.matrix.stage_device_blocks(k // n, k % n, vals)
            del vals
        self.t.finalize()
        self.m = dtt.create_tensor("M", inp.dims[:2], (0,), (1,), dtype=inp.dtype,
                                   device=run.device)
        self._fill_m("setup")
        self.c, self.last, self.norms = None, None, []

    def _fill_m(self, step) -> None:
        n = self.inp.n
        for _, idx, vals in self.inp.values("M", step):
            k = self.inp.keys["M"][idx]
            self.m.matrix.stage_device_blocks(k // n, k % n, vals)
        self.m.finalize()

    def step(self, i: int) -> None:
        with self.run.span("refill"):
            self._fill_m(i)
            self.c = None  # the previous step's answer is freed before the next is made
            c = dtt.create_tensor("C", self.inp.dims, (0, 1), (2,), dtype=self.inp.dtype,
                                  device=self.run.device).finalize()
        self.run.call(ENTRY, dtt.contract, 1.0, self.t, self.m, 0.0, c, **RI_KW)
        if i >= 0:
            with self.run.span("digest"):
                sq = sum(torch.linalg.vector_norm(b.data[:b.count], dtype=_wide(b.data)) ** 2
                         for b in c.matrix.bins)
            self.norms.append((i, sq))
            self.last = i
        self.c = c

    def release(self) -> None:
        """Drop the program's operands; the last answer stays."""
        self.t = self.m = None

    def check(self):
        limits = self.params["limits"]
        t_op = self.inp.operand("T", "setup")
        cm = self.c.matrix
        got = {"pattern_mismatch": 0, "rel_err": 0.0, "norm_rel_err": 0.0}
        failed = 0
        for i, sq in self.norms:
            ops = self.inp.operands(i, t_op)
            if i == self.last:
                r = ref.compare(output_groups(cm), cm.keys, *ops, self.run.device)
                print(f"last step: largest difference {r['abs_diff']!r} of largest value "
                      f"{r['scale']!r}; {r['differ']} values differ", file=sys.stderr)
            else:
                r = {"norm2": ref.norm2(*ops, self.run.device)}
            r["norm_rel_err"] = ref.norm_rel_err(float(sq), r["norm2"])
            failed += any(r[k] > limits[k] for k in got if k in r)
            for k in got:
                if k in r:
                    got[k] = max(got[k], r[k])
        self.c = None
        return ({k: (v, limits[k]) for k, v in got.items()}, len(self.norms), failed)


def setup(run, cfg, params, seed) -> State:
    return State(run, cfg, params, seed)
