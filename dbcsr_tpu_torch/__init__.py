"""dbcsr_tpu_torch: the PyTorch/CUDA port of dbcsr_tpu.

Block-sparse (BCSR) matrices and their multiply on an NVIDIA GPU: the
stack format, whose small block products run in CUDA kernels written
for Hopper (``csrc/``, built with nvcc at first use) after a C++ index
engine plans them on the host (``native/``, built with g++ at first
use), and the dense and composite formats, picked per product by
``mm/format_planner.py``.  The JAX package ``dbcsr_tpu`` is the reference this port is
tested against; this package imports nothing of it.

The package root exports the JAX package's public surface (the
`dbcsr_api.F` analog list) with the same meaning; ``replicate_all`` is
`parallel.replicate`, the distributed engine's replication onto a
process grid.  Importing it builds nothing and touches no card: the kernels and the index
engine build at their first use.

Entry points place their tensors on the default device, "cuda" unless
`dbcsr_tpu_torch.device.set_default_device` or a ``device=`` argument
says otherwise.

    import dbcsr_tpu_torch as dt
    dt.run_tests((48, 36, 52), sparsities=(0.4, 0.4, 0.4), test_type=dt.TEST_MM)

    from dbcsr_tpu_torch.perf.driver import parse_perf_file, run_perf
    run_perf(parse_perf_file("tests/inputs/test_H2O.perf"))
"""

from dbcsr_tpu_torch.core.kinds import (
    dbcsr_type_complex_4,
    dbcsr_type_complex_8,
    dbcsr_type_real_4,
    dbcsr_type_real_8,
    dtype_of,
)
from dbcsr_tpu_torch.core.config import (
    get_config,
    get_default_config,
    print_config,
    set_config,
)
from dbcsr_tpu_torch.core.lib import finalize_lib, init_lib, print_statistics
from dbcsr_tpu_torch.core.dist import (
    Distribution,
    ProcessGrid,
    convert_offsets_to_sizes,
    convert_sizes_to_offsets,
    dist_bin,
)
from dbcsr_tpu_torch.core.matrix import BlockIterator, BlockSparseMatrix, create
from dbcsr_tpu_torch.core import mempool
from dbcsr_tpu_torch.core.mempool import chain
from dbcsr_tpu_torch.mm.multiply import multiply
from dbcsr_tpu_torch import obs
from dbcsr_tpu_torch import resilience
from dbcsr_tpu_torch.ops.operations import (
    FUNC_ARTANH,
    FUNC_ASIN,
    FUNC_COS,
    FUNC_DDSIN,
    FUNC_DDTANH,
    FUNC_DSIN,
    FUNC_DTANH,
    FUNC_INVERSE,
    FUNC_INVERSE_SPECIAL,
    FUNC_SIN,
    FUNC_SPREAD_FROM_ZERO,
    FUNC_TANH,
    FUNC_TRUNCATE,
    add,
    add_on_diag,
    clear,
    column_norms,
    copy,
    copy_into_existing,
    crop_matrix,
    dot,
    filter_matrix,
    frobenius_norm,
    function_of_elements,
    gershgorin_norm,
    get_block_diag,
    get_diag,
    hadamard_product,
    maxabs_norm,
    reserve_all_blocks,
    reserve_blocks,
    reserve_diag_blocks,
    scale,
    scale_by_vector,
    set_diag,
    set_value,
    trace,
    triu,
    verify_matrix,
)
from dbcsr_tpu_torch.ops.transformations import (
    desymmetrize,
    new_transposed,
    redistribute,
    submatrix,
)
from dbcsr_tpu_torch.ops.csr import (
    CSR_DBCSR_BLKROW_DIST,
    CSR_EQROW_CEIL_DIST,
    CSR_EQROW_FLOOR_DIST,
    CsrMatrix,
    complete_redistribute,
    csr_create_from_matrix,
    csr_from_matrix,
    csr_print_sparsity,
    csr_write,
    matrix_from_csr,
    to_csr_filter,
)
from dbcsr_tpu_torch.ops.io import binary_read, binary_write, print_block_sum, print_matrix
from dbcsr_tpu_torch.ops.test_methods import (
    checksum,
    from_dense,
    make_random_matrix,
    reset_randmat_seed,
    to_dense,
)
from dbcsr_tpu_torch.ops.tests import TEST_BINARY_IO, TEST_MM, run_tests
# ref dbcsr_replicate_all (`dbcsr_transformations.F:108`)
from dbcsr_tpu_torch.parallel.dist_matrix import replicate as replicate_all

__version__ = "0.1.0"

__all__ = [
    "BlockIterator",
    "BlockSparseMatrix",
    "CSR_DBCSR_BLKROW_DIST",
    "CSR_EQROW_CEIL_DIST",
    "CSR_EQROW_FLOOR_DIST",
    "CsrMatrix",
    "Distribution",
    "FUNC_ARTANH",
    "FUNC_ASIN",
    "FUNC_COS",
    "FUNC_DDSIN",
    "FUNC_DDTANH",
    "FUNC_DSIN",
    "FUNC_DTANH",
    "FUNC_INVERSE",
    "FUNC_INVERSE_SPECIAL",
    "FUNC_SIN",
    "FUNC_SPREAD_FROM_ZERO",
    "FUNC_TANH",
    "FUNC_TRUNCATE",
    "ProcessGrid",
    "TEST_BINARY_IO",
    "TEST_MM",
    "add",
    "add_on_diag",
    "binary_read",
    "binary_write",
    "chain",
    "checksum",
    "clear",
    "column_norms",
    "complete_redistribute",
    "convert_offsets_to_sizes",
    "convert_sizes_to_offsets",
    "copy",
    "copy_into_existing",
    "create",
    "crop_matrix",
    "csr_create_from_matrix",
    "csr_from_matrix",
    "csr_print_sparsity",
    "csr_write",
    "dbcsr_type_complex_4",
    "dbcsr_type_complex_8",
    "dbcsr_type_real_4",
    "dbcsr_type_real_8",
    "desymmetrize",
    "dist_bin",
    "dot",
    "dtype_of",
    "filter_matrix",
    "finalize_lib",
    "frobenius_norm",
    "from_dense",
    "function_of_elements",
    "gershgorin_norm",
    "get_block_diag",
    "get_config",
    "get_default_config",
    "get_diag",
    "hadamard_product",
    "init_lib",
    "make_random_matrix",
    "matrix_from_csr",
    "maxabs_norm",
    "mempool",
    "multiply",
    "new_transposed",
    "obs",
    "print_block_sum",
    "print_config",
    "print_matrix",
    "print_statistics",
    "replicate_all",
    "redistribute",
    "reserve_all_blocks",
    "reserve_blocks",
    "reserve_diag_blocks",
    "reset_randmat_seed",
    "resilience",
    "run_tests",
    "scale",
    "scale_by_vector",
    "set_config",
    "set_diag",
    "set_value",
    "submatrix",
    "to_csr_filter",
    "to_dense",
    "trace",
    "triu",
    "verify_matrix",
]
