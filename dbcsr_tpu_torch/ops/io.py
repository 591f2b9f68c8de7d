"""Binary matrix I/O (the checkpoint and restore path) and the print
helpers.

Counterpart of `dbcsr_tpu/ops/io.py` (ref `src/ops/dbcsr_io.F`:
`dbcsr_binary_write` :578, `dbcsr_binary_read` :757, `dbcsr_print`,
`dbcsr_print_block_sum` :1081).  The file format is the JAX package's,
byte for byte: the magic ``DBCSRTPU``, a little-endian int64 header
length, a JSON header (version, name, dtype as a numpy type string,
matrix type, blockings, block count, and each bin's shape and count),
then the index (int64 keys, int32 bin and slot of each entry) and each
bin's blocks as raw little-endian values.  A file written by either
package reads back in the other.  bfloat16 has no numpy type string
the other package can read, so a bfloat16 matrix is refused.
"""

from __future__ import annotations

import json
import struct
import sys
from typing import Optional

import numpy as np
import torch

from dbcsr_tpu_torch.core.dist import Distribution
from dbcsr_tpu_torch.core.kinds import dtype_of
from dbcsr_tpu_torch.core.matrix import BlockSparseMatrix, _Bin, to_host
from dbcsr_tpu_torch.device import DeviceLike

_MAGIC = b"DBCSRTPU"
_VERSION = 1
# the numpy type string of each dtype a file may hold
_FILE_DTYPES = {torch.float32: "<f4", torch.float64: "<f8", torch.complex64: "<c8",
                torch.complex128: "<c16"}


def binary_write(matrix: BlockSparseMatrix, path: str) -> None:
    """Serialize a finalized matrix (ref `dbcsr_binary_write`); one
    device-to-host copy per bin."""
    if not matrix.valid:
        raise RuntimeError("finalize() first")
    if matrix.dtype not in _FILE_DTYPES:
        raise TypeError(f"binary I/O takes float32/float64/complex64/complex128, "
                        f"got {matrix.dtype}")
    header = {
        "version": _VERSION,
        "name": matrix.name,
        "dtype": np.dtype(_FILE_DTYPES[matrix.dtype]).str,
        "matrix_type": matrix.matrix_type,
        "row_blk_sizes": matrix.row_blk_sizes.tolist(),
        "col_blk_sizes": matrix.col_blk_sizes.tolist(),
        "nblks": int(matrix.nblks),
        "bins": [{"shape": list(b.shape), "count": int(b.count)} for b in matrix.bins],
    }
    hbytes = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<q", len(hbytes)))
        f.write(hbytes)
        matrix.keys.astype("<i8").tofile(f)
        matrix.ent_bin.astype("<i4").tofile(f)
        matrix.ent_slot.astype("<i4").tofile(f)
        for b in matrix.bins:
            to_host(b.data[: b.count]).astype(header["dtype"]).tofile(f)


def binary_read(path: str, dist: Optional[Distribution] = None, name: Optional[str] = None,
                device: Optional[DeviceLike] = None) -> BlockSparseMatrix:
    """Restore a matrix onto ``device``, optionally under a new
    distribution (ref `dbcsr_binary_read`).  The file's index is
    checked (`ops.operations.verify_matrix`, without the data) before
    the matrix is returned."""
    from dbcsr_tpu_torch.ops.operations import verify_matrix

    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a dbcsr_tpu binary matrix")
        (hlen,) = struct.unpack("<q", f.read(8))
        header = json.loads(f.read(hlen).decode())
        if header["version"] != _VERSION:
            raise ValueError(f"unsupported version {header['version']}")
        nblks = header["nblks"]
        keys = np.fromfile(f, "<i8", nblks)
        ent_bin = np.fromfile(f, "<i4", nblks)
        ent_slot = np.fromfile(f, "<i4", nblks)
        if not len(keys) == len(ent_bin) == len(ent_slot) == nblks:
            raise ValueError(f"{path}: truncated index")
        fdt = np.dtype(header["dtype"])
        m = BlockSparseMatrix(name or header["name"], header["row_blk_sizes"],
                              header["col_blk_sizes"], dtype_of(fdt.newbyteorder("=")), dist,
                              header["matrix_type"], device=device)
        bins, shapes = [], []
        for binfo in header["bins"]:
            bm, bn = binfo["shape"]
            count = binfo["count"]
            host = np.fromfile(f, fdt, count * bm * bn)
            if host.size != count * bm * bn:
                raise ValueError(f"{path}: truncated block data")
            data = torch.from_numpy(host.astype(fdt.newbyteorder("="), copy=False)
                                    .reshape(count, bm, bn)).to(m.device, m.dtype)
            shapes.append((bm, bn))
            bins.append(_Bin((bm, bn), data, count))
    if len(set(shapes)) != len(shapes) or (len(ent_bin) and not (
            0 <= ent_bin.min() and ent_bin.max() < len(bins))):
        raise ValueError(f"{path}: inconsistent bins")
    m.set_structure_from_device(keys, bins, binning=(ent_bin, ent_slot, shapes))
    verify_matrix(m, check_data=False)
    return m


def print_matrix(matrix: BlockSparseMatrix, file=None, nodata: bool = False) -> None:
    """Human-readable dump: a header line, then every stored block (ref
    `dbcsr_print`, `src/ops/dbcsr_io.F`)."""
    out = file or sys.stdout
    info = matrix.get_info()
    print(f"DBCSR {info['name']!r} {info['nfullrows_total']}x{info['nfullcols_total']} "
          f"({info['nblkrows_total']}x{info['nblkcols_total']} blocks), "
          f"type={info['matrix_type']}, dtype={info['data_type']}, "
          f"{info['nblks']} blocks stored, occ={info['occupation']:.4f}", file=out)
    if nodata:
        return
    for r, c, blk in matrix.iterate_blocks():
        print(f" block ({r},{c}) {blk.shape[0]}x{blk.shape[1]}:", file=out)
        with np.printoptions(precision=6, suppress=True):
            print(np.array2string(blk, prefix="  "), file=out)


def print_block_sum(matrix: BlockSparseMatrix, file=None) -> None:
    """Print the element sum of each stored block, one line a block: a
    cheap fingerprint across implementations (ref
    `dbcsr_print_block_sum`, `src/ops/dbcsr_io.F:1081`).  Each bin's
    sums come from one device reduction in the matrix dtype."""
    out = file or sys.stdout
    sums = None
    for b_id, b in enumerate(matrix.bins):
        if b.count == 0:
            continue
        bin_sums = to_host(b.data.sum(dim=(1, 2)))
        if sums is None:
            sums = np.zeros(matrix.nblks, bin_sums.dtype)
        mask = matrix.ent_bin == b_id
        sums[mask] = bin_sums[matrix.ent_slot[mask]]
    rows, cols = matrix.entry_coords()
    for e in range(matrix.nblks):
        print(f"{int(rows[e]) + 1:7d} {int(cols[e]) + 1:7d} {sums[e]:.10E}", file=out)
