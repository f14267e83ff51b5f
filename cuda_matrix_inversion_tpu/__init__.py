"""cuda_matrix_inversion_tpu — a JAX batched dense linear-algebra framework.

A from-scratch JAX/XLA/Pallas rebuild of the capability surface of the
reference CUDA library ``akuendig/cuda-matrix-inversion``:

* batched small-dense-matrix inversion (Gauss-Jordan with row pivoting,
  Cholesky, LU) — reference ``include/inverse_gpu.h:7-31``,
  ``include/inverse_cpu.h:8-15``
* the Gaussian-Process predictive mean/variance pipeline
  ``mean = aᵀ(B+diag c)⁻¹ d``, ``var = e − aᵀ(B+diag c)⁻¹ a`` —
  reference ``include/gauss_cpu.h:16-58``, ``src/gauss_bench.cu:127-409``
* ``.mats`` fixture I/O, batch replication, Welford-timed benchmark CLIs
  with CSV output — reference ``src/helper.cu``, ``include/timer.h``,
  ``src/inverse_bench.c``, ``src/gauss_bench.cu``

Design stance:

* batches are device-resident ``(batch, n, n)`` arrays, not pointer
  arrays; the reference's pitched ``batchedCudaMalloc``
  (``src/helper.cu:103-118``) has no analog because XLA owns layout.
* factorizations go to the vendor's batched solvers through XLA (the
  reference's fastest design, cuBLAS batched LU); a hand-written kernel
  stays only where it beats them — the Newton–Schulz lanes run one
  Triton program per matrix.
* the two-flavor API split of the reference (`*_batched_gpu` host
  convenience vs `*_batched_device` device-resident composable —
  ``include/inverse_gpu.h``) is preserved as: NumPy-in/NumPy-out
  convenience wrappers vs jit-composable device functions.
* scale-out shards the batch axis over the devices of a host with
  ``jax.sharding``/``shard_map`` (the reference is single-GPU).
"""

from cuda_matrix_inversion_tpu.types import (
    MatrixBatch,
    default_dtype,
    set_default_dtype,
)
from cuda_matrix_inversion_tpu.io.mats import (
    read_mats,
    write_mats,
    read_test_folder,
)
from cuda_matrix_inversion_tpu.io.replicate import replicate_matrices
from cuda_matrix_inversion_tpu.ops.registry import (
    get_inverse_algorithm,
    list_inverse_algorithms,
)
from cuda_matrix_inversion_tpu.ops.host_api import (
    inverse_batched,
    solve_batched,
)
from cuda_matrix_inversion_tpu.models.gp import (
    gp_log_marginal_likelihood,
    gp_mean_variance,
    gp_mean_variance_multi,
)
from cuda_matrix_inversion_tpu.models.gp_fit import (
    GPFitResult,
    fit_gp_scales,
)
from cuda_matrix_inversion_tpu.engine import GPEngine, InversionEngine

__version__ = "0.1.0"

__all__ = [
    "MatrixBatch",
    "default_dtype",
    "set_default_dtype",
    "read_mats",
    "write_mats",
    "read_test_folder",
    "replicate_matrices",
    "get_inverse_algorithm",
    "list_inverse_algorithms",
    "inverse_batched",
    "solve_batched",
    "gp_mean_variance",
    "gp_mean_variance_multi",
    "gp_log_marginal_likelihood",
    "fit_gp_scales",
    "GPFitResult",
    "InversionEngine",
    "GPEngine",
    "__version__",
]
