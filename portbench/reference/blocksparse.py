"""The plain reference: C = alpha * A @ B + beta * C0 of block-sparse
operands, worked out densely, a chunk of A's block rows at a time.

An operand is an ``Operand``: its sorted block keys (row * ncols + col),
its row and column blockings, and its values as shape groups
[((bm, bn), index into keys, (N, bm, bn) tensor), ...], which the
benchmark draws (``portbench/inputs.py``) and hands alike to the program
and to this module.  The result's pattern is the symbolic one: C0's
blocks and every block a product reaches, with no filtering.

A program's answer is judged by `compare`: its pattern against the
reference's, key for key, and the largest difference of a value over
the largest reference value.  Both run on the device, one chunk of rows
at a time, beside the program's C.

Plain PyTorch and NumPy only: nothing of the program is imported or
read except the answer under judgement.  TF32 is off in every matmul.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Operand:
    keys: np.ndarray
    row_sizes: np.ndarray
    col_sizes: np.ndarray
    groups: list  # [((bm, bn), index into keys, (N, bm, bn) tensor)]

    @property
    def ncols(self) -> int:
        return len(self.col_sizes)


@contextlib.contextmanager
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _wide(op: "Operand"):
    """The reference's type: float64, or complex128 for complex values."""
    complex_ = any(vals.is_complex() for _, _, vals in op.groups)
    return torch.complex128 if complex_ else torch.float64


def _norm2(c) -> float:
    return float(torch.real(c * c.conj()).sum())


def offsets(sizes) -> np.ndarray:
    """Element offsets of a blocking, with the total last."""
    return np.concatenate([[0], np.cumsum(np.asarray(sizes, np.int64))])


def _element_grid(keys, ncols, rows_map, col_off, device):
    """Element row and column indices of each block, broadcastable:
    (N, bm, 1) and (N, 1, bn) for blocks of one shape (rows through
    ``rows_map``: block row -> element offset in the chunk)."""
    r, c = keys // ncols, keys % ncols
    return (torch.from_numpy(rows_map[r]).to(device),
            torch.from_numpy(col_off[c]).to(device))


def _scatter(dense, keys, ncols, rows_map, col_off, vals, chunk=1 << 14):
    bm, bn = vals.shape[1], vals.shape[2]
    dev = dense.device
    ar, ac = torch.arange(bm, device=dev), torch.arange(bn, device=dev)
    for s in range(0, len(keys), chunk):
        r0, c0 = _element_grid(keys[s:s + chunk], ncols, rows_map, col_off, dev)
        dense[(r0[:, None] + ar)[:, :, None], (c0[:, None] + ac)[:, None, :]] = \
            vals[s:s + chunk].to(dense.dtype)


def gather_blocks(dense, keys, ncols, rows_map, col_off, shape):
    """The blocks ``keys`` of one ``shape`` from the dense rows ``dense``
    (block rows placed by ``rows_map``), as an (N, bm, bn) tensor."""
    bm, bn = shape
    dev = dense.device
    ar, ac = torch.arange(bm, device=dev), torch.arange(bn, device=dev)
    r0, c0 = _element_grid(keys, ncols, rows_map, col_off, dev)
    return dense[(r0[:, None] + ar)[:, :, None], (c0[:, None] + ac)[:, None, :]]


def densify(op: Operand, dtype, device, block_rows=None) -> torch.Tensor:
    """``op`` as a dense matrix in ``dtype``; with ``block_rows`` (sorted),
    only those block rows, stacked in that order."""
    row_off, col_off = offsets(op.row_sizes), offsets(op.col_sizes)
    rows_map = row_off[:-1].copy()
    nrows = int(row_off[-1])
    if block_rows is not None:
        heights = op.row_sizes[block_rows]
        rows_map = np.full(len(op.row_sizes), -1, np.int64)
        rows_map[block_rows] = offsets(heights)[:-1]
        nrows = int(heights.sum())
    out = torch.zeros((nrows, int(col_off[-1])), dtype=dtype, device=device)
    for _, idx, vals in op.groups:
        keys = op.keys[idx]
        if block_rows is not None:
            sel = np.nonzero(rows_map[keys // op.ncols] >= 0)[0]
            keys, vals = keys[sel], vals[torch.from_numpy(sel).to(vals.device)]
        _scatter(out, keys, op.ncols, rows_map, col_off, vals)
    return out


def _row_chunks(row_sizes, present_rows, max_rows: int) -> list:
    chunks, cur, height = [], [], 0
    for r in present_rows:
        h = int(row_sizes[r])
        if cur and height + h > max_rows:
            chunks.append(np.asarray(cur, np.int64))
            cur, height = [], 0
        cur.append(r)
        height += h
    if cur:
        chunks.append(np.asarray(cur, np.int64))
    return chunks


def product_chunks(a: Operand, b: Operand, c0: Operand, alpha, beta, dtype, device,
                   max_rows: int = 1 << 14):
    """Yield the reference product one chunk of C's block rows at a time:
    (block rows, dense rows of C for them in ``dtype``, the pattern's
    sorted keys in those rows).  Rows that no product and no C0 block
    reach hold nothing and are skipped."""
    nk, nc = len(a.col_sizes), len(b.col_sizes)
    b_dense = densify(b, dtype, device)
    pb = torch.zeros((nk, nc), dtype=torch.float32, device=device)
    pb.view(-1)[torch.from_numpy(b.keys).to(device)] = 1.0
    present = np.union1d(np.unique(a.keys // nk), np.unique(c0.keys // nc))
    with no_tf32():
        for rows in _row_chunks(a.row_sizes, present, max_rows):
            c = densify(c0, dtype, device, rows)
            if beta != 1.0:
                c.mul_(beta)
            a_rows = densify(a, dtype, device, rows)
            c.add_(a_rows @ b_dense, alpha=alpha)
            del a_rows
            # the pattern: blocks of C0, and (i, j) wherever A[i, :] meets B[:, j]
            local = np.full(len(a.row_sizes), -1, np.int64)
            local[rows] = np.arange(len(rows))
            pa = torch.zeros((len(rows), nk), dtype=torch.float32, device=device)
            ak = a.keys[local[a.keys // nk] >= 0]
            pa[torch.from_numpy(local[ak // nk]).to(device),
               torch.from_numpy(ak % nk).to(device)] = 1.0
            hit = (pa @ pb) > 0
            ck = c0.keys[local[c0.keys // nc] >= 0]
            hit[torch.from_numpy(local[ck // nc]).to(device),
                torch.from_numpy(ck % nc).to(device)] = True
            li, lj = (x.cpu().numpy() for x in torch.nonzero(hit, as_tuple=True))
            yield rows, c, rows[li] * nc + lj


def compare(got: list, got_keys: np.ndarray, a: Operand, b: Operand, c0: Operand,
            alpha, beta, device, max_rows: int = 1 << 14) -> dict:
    """Judge a program's C against the reference in float64 (complex128
    for complex values).

    ``got`` is the answer as shape groups [((bm, bn), sorted keys, slots,
    (M, bm, bn) tensor)], block ``keys[i]`` lying at ``data[slots[i]]``,
    and ``got_keys`` all its keys, sorted.  Returns the blocks in one
    pattern and not the other (``pattern_mismatch``), the largest
    difference over the largest reference value (``rel_err``) and the
    reference's squared norm; besides, the largest absolute difference
    (``abs_diff``), the largest reference value (``scale``) and the count
    of values that differ at all (``differ``)."""
    nc = len(b.col_sizes)
    col_off = offsets(b.col_sizes)
    mismatch, diff, scale, norm2, differ = 0, 0.0, 0.0, 0.0, 0
    covered = 0
    wide = _wide(a)
    for rows, c, ref_keys in product_chunks(a, b, c0, alpha, beta, wide, device, max_rows):
        lo, hi = rows[0] * nc, (rows[-1] + 1) * nc
        in_rows = got_keys[(got_keys >= lo) & (got_keys < hi)]
        in_rows = in_rows[np.isin(in_rows // nc, rows)]
        covered += len(in_rows)
        mismatch += len(np.setxor1d(in_rows, ref_keys))
        scale = max(scale, float(c.abs().max()))
        norm2 += _norm2(c)
        rows_map = np.full(len(a.row_sizes), -1, np.int64)
        rows_map[rows] = offsets(a.row_sizes[rows])[:-1]
        for shape, keys, slots, data in got:
            sel = np.nonzero(np.isin(keys // nc, rows))[0]
            for s in range(0, len(sel), 1 << 12):
                part = sel[s:s + (1 << 12)]
                mine = data.index_select(0, torch.from_numpy(slots[part]).to(data.device))
                ref = gather_blocks(c, keys[part], nc, rows_map, col_off, shape)
                gap = (mine.to(wide) - ref).abs()
                diff = max(diff, float(gap.max()))
                differ += int((gap > 0).sum())
        del c
    # blocks of the answer in rows that the reference never reaches
    mismatch += len(got_keys) - covered
    return {"pattern_mismatch": mismatch, "rel_err": diff / max(scale, 1e-300),
            "norm2": norm2, "abs_diff": diff, "scale": scale, "differ": differ}


def norm2(a: Operand, b: Operand, c0: Operand, alpha, beta, device,
          max_rows: int = 1 << 14) -> float:
    """The reference product's squared Frobenius norm, in float64."""
    return sum(_norm2(c) for _, c, _ in
               product_chunks(a, b, c0, alpha, beta, _wide(a), device, max_rows))


def groups_norm2(got: list) -> float:
    """The squared Frobenius norm of an answer given as shape groups
    (`compare`'s ``got``), in float64 (complex128 for complex values)."""
    total = 0.0
    for _, _, slots, data in got:
        blocks = data.index_select(0, torch.from_numpy(slots).to(data.device))
        wide = torch.complex128 if blocks.is_complex() else torch.float64
        total += float(torch.linalg.vector_norm(blocks, dtype=wide) ** 2)
    return total


def norm_rel_err(got_norm2: float, ref_norm2: float) -> float:
    """The gap between an answer's norm and the reference's, over the
    reference's norm."""
    ref_norm = ref_norm2 ** 0.5
    return abs(got_norm2 ** 0.5 - ref_norm) / max(ref_norm, 1e-300)
