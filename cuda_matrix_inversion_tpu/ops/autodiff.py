"""Autodiff support for the custom inversion paths.

A framework op must compose with ``jax.grad``; the Pallas kernels have no
VJP and Newton-Schulz uses ``lax.while_loop`` (not reverse-mode
differentiable).  The analytic rule closes both gaps exactly:

    X = A⁻¹  ⇒  dX = −X · dA · X      (so  Ā = −Xᵀ · X̄ · Xᵀ)

i.e. the backward pass is two batched matmuls against the primal OUTPUT —
no re-factorization, matrix products only, and numerically the right thing (it is the
true derivative of the exact inverse, independent of which algorithm
produced X).

No reference counterpart: the CUDA library is inference-only C.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST


def with_inverse_vjp(fn: Callable, name: str | None = None) -> Callable:
    """Wrap a batched-inverse function with the analytic inverse VJP."""

    @jax.custom_vjp
    def inv(a):
        return fn(a)

    def fwd(a):
        x = fn(a)
        return x, x  # residual: the inverse itself

    def bwd(x, g):
        xt = jnp.swapaxes(x, -1, -2)
        grad_a = -jnp.matmul(jnp.matmul(xt, g, precision=_PREC), xt,
                             precision=_PREC)
        return (grad_a,)

    inv.defvjp(fwd, bwd)
    if name:
        inv.__name__ = name
    inv.__doc__ = (fn.__doc__ or "") + "\n\n    Differentiable: dX = -X dA X."
    return inv


def differentiable(algorithm: str) -> Callable:
    """A jax.grad-compatible batched inverse for any registry algorithm."""
    from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

    return with_inverse_vjp(get_inverse_algorithm(algorithm),
                            name=f"inverse_{algorithm}_diff")
