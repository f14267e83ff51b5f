"""XLA-native batched ops — the device-resident composable layer.

The analogs of the reference's ``*_batched_device`` API
(``include/inverse_gpu.h:10-23``): jit-composable functions over
device-resident ``(batch, n, n)`` arrays.  On the GPU, XLA hands the
factorizations to the vendor's batched solvers (cuSOLVER/cuBLAS getrf,
potrf, trsm) — the reference's own fastest design.  The host-facing
``*_gpu``-flavor convenience wrappers (alloc→H2D→compute→D2H in the
reference, ``src/gauss/inverse_gpu.cu:60-123``) live in :mod:`.host_api`.

Every matrix product runs IEEE fp32 (``precision.F32``), keeping
‖AA⁻¹−I‖∞ within the 1e-4 gate; float64 inputs stay f64 throughout.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from cuda_matrix_inversion_tpu.ops.precision import matmul as _mm


def add_diagonal(b: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Batched ``B + diag(c)`` (ref ``addDiagonal`` kernel,
    ``src/gauss_bench.cu:38-61``).  ``b``: (batch, n, n); ``c``: (batch, n)
    or (batch, n, 1)."""
    if c.ndim == 3:
        c = c[..., 0]
    n = b.shape[-1]
    return b + jnp.eye(n, dtype=b.dtype) * c[:, None, :]


def matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched matmul (ref ``batchedMul`` over cublasSgemmBatched,
    ``src/gauss_bench.cu:87-107``)."""
    return _mm(a, b)


def inverse_lu(a: jnp.ndarray) -> jnp.ndarray:
    """Batched general inversion via XLA's LU path — the analog of
    ``inverse_lu_cuda_batched_device`` (cublasSgetrf/SgetriBatched,
    ``src/gauss/inverse_gpu.cu:16-58``).

    In fp32 one Newton residual-polish step (X ← X + X(I − AX), fp32
    products) follows the factorization.  The raw factorization's fp32
    residual is κ-proportional, not just n-proportional (~1e-3 by n ≈ 512
    on the κ ≈ 2–4 SPD fixtures, 7e-4 at n = 128 / κ ≈ 512 on the
    general-square family — past the 1e-4 gate), so the polish runs
    unconditionally in fp32.  Non-finite inputs/singular matrices still
    propagate NaN.
    """
    x = jnp.linalg.inv(a)
    if a.dtype != jnp.float64:
        eye = jnp.eye(a.shape[-1], dtype=x.dtype)
        r = eye - _mm(a, x)
        x = x + _mm(x, r)
    return x


def cholesky(a: jnp.ndarray) -> jnp.ndarray:
    """Batched lower Cholesky factor (ref ``decompose_cholesky_*``
    kernels, ``src/inverse_cholesky_gpu.cu:55-100,274-283,465-515``)."""
    return jnp.linalg.cholesky(a)


def triangular_inverse_lower(l: jnp.ndarray) -> jnp.ndarray:
    """W = L⁻¹ for batched lower-triangular L (ref ``inverse_upper_*`` /
    ``inverse_lower_mm_kernel_device``, ``src/inverse_cholesky_gpu.cu:102-141,
    517-561``)."""
    n = l.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=l.dtype), l.shape)
    return lax.linalg.triangular_solve(
        l, eye, left_side=True, lower=True, unit_diagonal=False
    )


def inverse_cholesky(a: jnp.ndarray) -> jnp.ndarray:
    """Batched SPD inversion: A⁻¹ = WᵀW with W = L⁻¹ — fuses the
    decompose→triangular-inverse→multiply phases that the reference runs
    as separate kernel families (``inverse_cholesky_batched_device``,
    ``src/inverse_cholesky_gpu.cu:322-354``; ``multiply_lower_mm``
    ``:563-604``)."""
    w = triangular_inverse_lower(cholesky(a))
    return _mm(jnp.swapaxes(w, -1, -2), w)


def spd_logdet(a: jnp.ndarray) -> jnp.ndarray:
    """Batched log|A| for SPD batches via Cholesky: 2·Σ log L_ii.

    Beyond-parity capability (the reference computes no determinants):
    the natural companion of the GP pipelines — log-marginal-likelihood
    needs log|K| — and free given the factorization the solve already
    does.  Returns (batch,) in the input dtype's precision domain.
    """
    l = cholesky(a)
    diag = jnp.diagonal(l, axis1=-2, axis2=-1)
    return 2.0 * jnp.sum(jnp.log(diag), axis=-1)


def lu_logdet(a: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched (sign, log|A|) for GENERAL batches via LU with pivoting —
    the non-SPD sibling of :func:`spd_logdet`.  Same contract as
    ``numpy.linalg.slogdet``."""
    sign, logdet = jnp.linalg.slogdet(a)
    return sign, logdet


def lu_solve(a: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """Batched general solve AX = RHS via LU, no explicit inverse — the
    general-matrix sibling of :func:`spd_solve` (the reference only ships
    the SPD ``spotrs_`` solve, ``src/gauss_cpu.c:118-131``; the LU solve
    completes the capability for non-symmetric systems)."""
    return jnp.linalg.solve(a, rhs)


def spd_solve(a: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """Batched SPD solve via Cholesky, no explicit inverse (ref
    ``spotrf_``+``spotrs_`` path, ``src/gauss_cpu.c:118-131``)."""
    l = cholesky(a)
    y = lax.linalg.triangular_solve(l, rhs, left_side=True, lower=True)
    return lax.linalg.triangular_solve(
        l, y, left_side=True, lower=True, transpose_a=True
    )


@partial(jax.jit, static_argnames=("algorithm",))
def batched_inverse(a: jnp.ndarray, algorithm: str = "lu") -> jnp.ndarray:
    """Dispatching batched inverse (ref ``batchedInverse``,
    ``src/gauss_bench.cu:63-85``)."""
    from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

    return get_inverse_algorithm(algorithm)(a)
