"""Gaussian-Process predictive mean/variance pipelines — the flagship model.

Math (reference ``include/gauss_cpu.h:16-58``, fixtures
``tests/generate_gaussian_matrices.m:36-37``):

    mean = aᵀ (B + diag c)⁻¹ d
    var  = e − aᵀ (B + diag c)⁻¹ a

The reference runs this as four separately-launched device stages with
host control between them — addDiagonal → batched LU inverse → gemv → dot
(``calcluateMean`` ``src/gauss_bench.cu:127-265``, ``calcluateVariance``
``:275-409``).  Here the whole pipeline is ONE jitted XLA region: no host
round-trips, XLA fuses the add into the factorization's input and the two
matvecs into a single 2-RHS solve.

Inputs are batched: a,c,d — (batch, n, 1); B — (batch, n, n); e — (batch, 1, 1).
Outputs are (batch, 1, 1), matching ``means.mats``/``variances.mats``.

The reference's ``-DGAUSS_SOLVE`` build flag (``Makefile:119-121``) picks
potrs-solve over explicit inversion; here that's ``method='solve'`` (the
default — strictly less work) vs ``method='inverse'`` / ``'lu'``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from cuda_matrix_inversion_tpu.ops import xla as ops
from cuda_matrix_inversion_tpu.ops.precision import matmul as _mm


def _kinv_apply(b, c, rhs, method: str):
    """(B + diag c)⁻¹ @ rhs for a stack of RHS columns."""
    k = ops.add_diagonal(b, c)
    if method == "solve":
        return ops.spd_solve(k, rhs)
    if method == "inverse":
        return _mm(ops.inverse_cholesky(k), rhs)
    if method == "lu":
        # the reference GPU pipeline's choice: batched LU inversion
        # (``batchedInverse`` → cuBLAS LU, ``src/gauss_bench.cu:63-85``)
        return _mm(ops.inverse_lu(k), rhs)
    if method == "newton_schulz":
        from cuda_matrix_inversion_tpu.ops.newton_schulz import (
            inverse_newton_schulz,
        )

        return _mm(inverse_newton_schulz(k), rhs)
    raise ValueError(f"unknown method {method!r}")


@partial(jax.jit, static_argnames=("method",))
def gp_mean(a, b, c, d, method: str = "solve"):
    """Batched predictive mean (ref ``calcluateMean``,
    ``src/gauss_bench.cu:127-265``)."""
    x = _kinv_apply(b, c, d, method)  # (batch, n, 1)
    return _mm(jnp.swapaxes(a, -1, -2), x)


@partial(jax.jit, static_argnames=("method",))
def gp_variance(a, b, c, e, method: str = "solve"):
    """Batched predictive variance, documented sign (ref
    ``calcluateVariance`` ``src/gauss_bench.cu:275-409``; the reference CPU
    sign bug ``gauss_cpu.c:198,266`` is not reproduced — SURVEY §2.4.1)."""
    x = _kinv_apply(b, c, a, method)
    quad = _mm(jnp.swapaxes(a, -1, -2), x)
    return e - quad


@partial(jax.jit, static_argnames=("method",))
def gp_mean_variance(a, b, c, d, e, method: str = "solve"):
    """Fused mean+variance: one factorization, one 2-RHS solve — the
    composition the reference runs as two full pipelines
    (``gauss_bench.cu:672-689``) collapses to a single kernel graph."""
    rhs = jnp.concatenate([d, a], axis=-1)  # (batch, n, 2)
    return _project(a, e, _kinv_apply(b, c, rhs, method))


def _project(a, e, x):
    """(mean, var) from x = K⁻¹[d a]: aᵀx gives [mean, aᵀK⁻¹a]."""
    proj = _mm(jnp.swapaxes(a, -1, -2), x)  # (batch, 1, 2)
    return proj[:, :, 0:1], e - proj[:, :, 1:2]


@jax.jit
def gp_mean_variance_warm(a, b, c, d, e, prev_kinv):
    """Warm GP mean/variance: refine ``prev_kinv`` — the K⁻¹ of a nearby
    batch, e.g. the previous timestep's — instead of solving cold.

    Returns ``(mean, var, kinv)``; chain ``kinv`` into the next call.
    Valid while the relative drift δ of K = B + diag(c) satisfies
    δ·κ(K) ≲ 0.3 and κ(K) ≲ 30 (the bf16 warm refinement's domain,
    :func:`..ops.newton_schulz.inverse_newton_schulz_warm`).
    """
    from cuda_matrix_inversion_tpu.ops.newton_schulz import (
        inverse_newton_schulz_warm,
    )

    kinv = inverse_newton_schulz_warm(ops.add_diagonal(b, c), prev_kinv)
    mean, var = _project(a, e, _mm(kinv, jnp.concatenate([d, a], axis=-1)))
    return mean, var, kinv


@partial(jax.jit, static_argnames=("method",))
def gp_mean_variance_multi(a, b, c, d, e, method: str = "solve"):
    """Mean/variance at ``m`` test points per system, ONE factorization.

    Beyond-parity capability: the reference pipelines take a single test
    vector per system (``a`` — (batch, n, 1), ``gauss_bench.cu:127-265``);
    serving usually wants a block of test points against the same
    training kernel.  Shapes: a — (batch, n, m); b — (batch, n, n);
    c, d — (batch, n, 1); e — (batch, m, 1) (prior variance per point).
    Returns mean, var — each (batch, m, 1).

    One Cholesky of K = B + diag c feeds an (n, m+1)-RHS solve; the
    variance needs only the diagonal of AᵀK⁻¹A, computed as a masked
    elementwise reduction — never the m×m cross-covariance.
    """
    rhs = jnp.concatenate([d, a], axis=-1)          # (batch, n, 1+m)
    x = _kinv_apply(b, c, rhs, method)
    at = jnp.swapaxes(a, -1, -2)                    # (batch, m, n)
    mean = _mm(at, x[:, :, 0:1])                   # (batch, m, 1)
    quad = jnp.sum(a * x[:, :, 1:], axis=1)[:, :, None]    # diag(AᵀK⁻¹A)
    return mean, e - quad


@jax.jit
def gp_log_marginal_likelihood(b, c, d):
    """Batched GP log marginal likelihood of the observations ``d`` under
    kernel ``K = B + diag c``:

        log p(d) = −½ dᵀK⁻¹d − ½ log|K| − n/2 · log 2π

    Beyond-parity capability (the reference stops at mean/variance): the
    quantity every GP hyper-parameter fit maximizes.  ONE Cholesky
    factorization feeds both the quadratic form (two triangular solves)
    and the log-determinant (diagonal of L) — XLA keeps L in HBM between
    the two consumers, no refactorization.  Differentiable: JAX's
    cholesky/triangular_solve rules give ∂/∂{b,c,d} for free, so this
    composes with ``jax.grad`` for kernel learning.

    Shapes: b — (batch, n, n); c, d — (batch, n, 1) → (batch,).
    """
    k = ops.add_diagonal(b, c)
    l = ops.cholesky(k)
    y = jax.lax.linalg.triangular_solve(l, d, left_side=True, lower=True)
    quad = jnp.sum(jnp.square(y), axis=(-2, -1))            # dᵀK⁻¹d
    return _lml_from(quad, l)


def _lml_from(quad, l):
    diag = jnp.diagonal(l, axis1=-2, axis2=-1)
    logdet = 2.0 * jnp.sum(jnp.log(diag), axis=-1)
    n = l.shape[-1]
    return -0.5 * (quad + logdet + n * jnp.log(2.0 * jnp.pi).astype(l.dtype))


def _lml_vjp_fwd(b, c, d):
    """Value plus the residuals of the analytic VJP: W = L⁻¹ (one batched
    trsm against I) and α = K⁻¹d = Wᵀ(Wd)."""
    l = ops.cholesky(ops.add_diagonal(b, c))
    w = ops.triangular_inverse_lower(l)
    t = _mm(w, d)                                         # W d
    alpha = _mm(jnp.swapaxes(w, -1, -2), t)               # K⁻¹ d
    return _lml_from(jnp.sum(jnp.square(t), axis=(-2, -1)), l), (w, alpha)


def _lml_vjp_bwd(res, g):
    """∂LML/∂K = ½(ααᵀ − K⁻¹), K⁻¹ = WᵀW; ∂LML/∂d = −α.  K = B + diag c,
    so ∂/∂B is the full matrix and ∂/∂c its diagonal."""
    w, alpha = res
    gk = 0.5 * (alpha * jnp.swapaxes(alpha, -1, -2)
                - _mm(jnp.swapaxes(w, -1, -2), w))
    gm = g[:, None, None].astype(gk.dtype)
    return (gm * gk, gm * jnp.diagonal(gk, axis1=-2, axis2=-1)[:, :, None],
            -gm * alpha)


@jax.custom_vjp
def gp_log_marginal_likelihood_vjp(b, c, d):
    """:func:`gp_log_marginal_likelihood` with an analytic custom VJP.

    The forward keeps W = L⁻¹ and α = K⁻¹d, so the backward is one
    batched WᵀW product plus elementwise math instead of autodiff through
    the Cholesky and triangular-solve rules — the hyper-parameter fit's
    hot loop.  First-order reverse mode only.
    """
    return _lml_vjp_fwd(b, c, d)[0]


gp_log_marginal_likelihood_vjp.defvjp(_lml_vjp_fwd, _lml_vjp_bwd)


# ---- host-facing flavor (NumPy in/out; analog of the *_gpu wrappers) ----

def gp_mean_host(a, b, c, d, method: str = "solve") -> np.ndarray:
    out = gp_mean(*(jnp.asarray(x) for x in (a, b, c, d)), method=method)
    return np.asarray(jax.device_get(out))


def gp_variance_host(a, b, c, e, method: str = "solve") -> np.ndarray:
    out = gp_variance(*(jnp.asarray(x) for x in (a, b, c, e)), method=method)
    return np.asarray(jax.device_get(out))


def gp_mean_variance_host(a, b, c, d, e, method: str = "solve"):
    mean, var = gp_mean_variance(*(jnp.asarray(x) for x in (a, b, c, d, e)), method=method)
    return np.asarray(jax.device_get(mean)), np.asarray(jax.device_get(var))
