"""Reference checksums of a `.perf` input's product, computed by the JAX
package on the CPU.

`chip_smoke.py`'s superstack phase gates the port's `mixed_blocks.perf`
product on the card against these numbers (the input itself carries no
reference).  The operands are drawn as both perf drivers draw them (one
numpy Generator, seed 12341313), so both packages multiply the same
values:

    JAX_PLATFORMS=cpu python tools/perf_reference.py tests/inputs/mixed_blocks.perf
    JAX_PLATFORMS=cpu python tools/perf_reference.py tests/inputs/mixed_blocks.perf --data-type 1

prints one JSON line: the input, the data type (1 = sreal, 3 = dreal),
checksum(C_out), the positional checksum and the seconds it took.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("perf_file")
    ap.add_argument("--data-type", type=int, default=None,
                    help="override the input's data type (1 sreal, 3 dreal)")
    args = ap.parse_args()
    from dbcsr_tpu.perf.driver import parse_perf_file, run_perf

    cfg = parse_perf_file(args.perf_file)
    if args.data_type is not None:
        cfg.data_type = args.data_type
    cfg.nrep = 1
    t0 = time.perf_counter()
    res = run_perf(cfg, verbose=False)
    print(json.dumps({"input": os.path.basename(args.perf_file), "data_type": cfg.data_type,
                      "checksum": res["checksum"], "checksum_pos": res["checksum_pos"],
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
