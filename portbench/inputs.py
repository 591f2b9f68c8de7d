"""Inputs of the benchmark: block patterns and block values from a seed.

The benchmark makes every operand itself and hands the same operands to
the program and to the plain reference (``reference/``).  Patterns are
drawn on the host with NumPy from a configuration's ``pattern_seed``, so
every run of a cell does the same amount of work; values are drawn on
the device from the run's ``--seed`` and a tag (the operand and the
step), with one ``torch.Generator`` call per block shape, so any step's
operands can be drawn again, bit for bit, after the window.

This module imports nothing of the program.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit generator seed from the run's seed and tags (any size of
    ``seed``: the driver's seeds pass 32 bits)."""
    text = "|".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1


def block_sizes(spec) -> np.ndarray:
    """A blocking from ``[[size, count], ...]``."""
    return np.concatenate([np.full(int(n), int(s), np.int64) for s, n in spec])


def random_pattern(nrows: int, ncols: int, occupancy: float, seed: int) -> np.ndarray:
    """Sorted keys (row * ncols + col) of round(occupancy * nrows * ncols)
    distinct blocks, drawn uniformly."""
    rng = np.random.default_rng(seed)
    count = int(round(occupancy * nrows * ncols))
    return np.sort(rng.choice(nrows * ncols, size=count, replace=False)).astype(np.int64)


def symmetric_pattern(n: int, occupancy: float, seed: int) -> np.ndarray:
    """Sorted keys of a symmetric pattern with the whole diagonal: a
    density matrix's, round(occupancy * n * n) blocks in all."""
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(n, 1)
    pairs = max(0, int(round((occupancy * n * n - n) / 2)))
    pick = rng.choice(len(iu), size=pairs, replace=False)
    rows = np.concatenate([np.arange(n), iu[pick], ju[pick]])
    cols = np.concatenate([np.arange(n), ju[pick], iu[pick]])
    return np.sort(rows.astype(np.int64) * n + cols)


def shape_groups(keys: np.ndarray, ncols: int, row_sizes, col_sizes) -> list:
    """The keys grouped by block shape, shapes in ascending order:
    [((bm, bn), index into keys), ...]."""
    bm = np.asarray(row_sizes)[keys // ncols]
    bn = np.asarray(col_sizes)[keys % ncols]
    code = bm.astype(np.int64) << 32 | bn
    return [((int(u >> 32), int(u & 0xFFFFFFFF)), np.nonzero(code == u)[0])
            for u in np.unique(code)]


def block_values(seed: int, groups: list, dtype, device, scale: float = 1.0,
                 diag_shift: float = 0.0, keys=None, ncols: int = 0) -> list:
    """Normal block values for each shape group, drawn on ``device`` by
    one generator seeded with ``seed``, one call per group:
    [(shape, index, (N, bm, bn) tensor), ...].  ``diag_shift`` adds a
    multiple of the identity to the diagonal blocks (``keys`` and
    ``ncols`` locate them)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for (bm, bn), idx in groups:
        vals = torch.randn((len(idx), bm, bn), generator=gen, dtype=dtype, device=device)
        if scale != 1.0:
            vals.mul_(scale)
        if diag_shift and bm == bn:
            k = keys[idx]
            on_diag = np.nonzero(k // ncols == k % ncols)[0]
            if len(on_diag):
                sel = torch.from_numpy(on_diag).to(device)
                eye = torch.eye(bm, dtype=dtype, device=device) * diag_shift
                vals[sel] += eye
        out.append(((bm, bn), idx, vals))
    return out
