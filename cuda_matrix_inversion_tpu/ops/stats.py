"""Batch statistics helpers: column mean, centering, covariance.

Reference counterpart: ``mean`` / ``sub_each`` / ``covariance`` in
``src/inverse.c:26-48`` (CBLAS ``ssyrk``-based) — present in the reference
but never called by any harness (SURVEY §2.1 row 11).  Provided here as
first-class, jit-compatible ops (and actually tested).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_PREC = lax.Precision.HIGHEST


def column_mean(x: jnp.ndarray) -> jnp.ndarray:
    """Mean of each column: (m, n) → (n,) (ref ``mean``, ``inverse.c:26-31``)."""
    return jnp.mean(x, axis=-2)


def subtract_column_mean(x: jnp.ndarray) -> jnp.ndarray:
    """Center columns (ref ``sub_each``, ``inverse.c:33-38``)."""
    return x - column_mean(x)[..., None, :]


def covariance(x: jnp.ndarray, ddof: int = 0) -> jnp.ndarray:
    """Column covariance (m, n) → (n, n) via XᶜᵀXᶜ as one matrix product
    (ref ``covariance`` over ``cblas_ssyrk``, ``inverse.c:40-48``).
    Batched inputs (..., m, n) are supported."""
    xc = subtract_column_mean(x)
    m = x.shape[-2]
    gram = jnp.matmul(jnp.swapaxes(xc, -1, -2), xc, precision=_PREC)
    return gram / max(m - ddof, 1)
