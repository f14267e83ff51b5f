"""Strassen matrix multiplication — port of the reference prototype.

Reference counterpart: ``Multiplication/multi.cu`` — a recursive Strassen
multiply with a size cutoff (``cutoff_thres = 12``, ``multi.cu:7``) below
which it calls a standard tiled kernel, plus add/subtract elementwise
kernels and 2-D submatrix copies.

Translation notes: the seven recursive products become seven jitted
subtrees that XLA schedules together; quadrant extraction is slicing (no
memCopy2D — XLA owns layout); odd dimensions are zero-padded per level
exactly like the reference pads its recursion.  The cutoff is raised to
matrix-unit scale: below ``cutoff`` a single ``jnp.matmul`` IS the fast
path — with tensor-core matrix products Strassen only pays off for very
large operands, which the docstring test demonstrates rather than hides.
Supports single matrices and leading batch dims.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST


def _pad_even(x, axis):
    if x.shape[axis] % 2 == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, 1)
    return jnp.pad(x, pad)


def _strassen(a, b, cutoff: int):
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    if min(m, k, n) <= cutoff:
        return jnp.matmul(a, b, precision=_PREC)

    a = _pad_even(_pad_even(a, -1), -2)
    b = _pad_even(_pad_even(b, -1), -2)
    m2, k2, n2 = a.shape[-2] // 2, a.shape[-1] // 2, b.shape[-1] // 2

    a11 = a[..., :m2, :k2]
    a12 = a[..., :m2, k2:]
    a21 = a[..., m2:, :k2]
    a22 = a[..., m2:, k2:]
    b11 = b[..., :k2, :n2]
    b12 = b[..., :k2, n2:]
    b21 = b[..., k2:, :n2]
    b22 = b[..., k2:, n2:]

    # the classic seven products (multi.cu strassen_multiply)
    p1 = _strassen(a11 + a22, b11 + b22, cutoff)
    p2 = _strassen(a21 + a22, b11, cutoff)
    p3 = _strassen(a11, b12 - b22, cutoff)
    p4 = _strassen(a22, b21 - b11, cutoff)
    p5 = _strassen(a11 + a12, b22, cutoff)
    p6 = _strassen(a21 - a11, b11 + b12, cutoff)
    p7 = _strassen(a12 - a22, b21 + b22, cutoff)

    c11 = p1 + p4 - p5 + p7
    c12 = p3 + p5
    c21 = p2 + p4
    c22 = p1 - p2 + p3 + p6

    c = jnp.concatenate(
        [jnp.concatenate([c11, c12], axis=-1),
         jnp.concatenate([c21, c22], axis=-1)],
        axis=-2,
    )
    return c[..., :m, :n]


@functools.partial(jax.jit, static_argnames=("cutoff",))
def strassen_matmul(a: jnp.ndarray, b: jnp.ndarray, cutoff: int = 512) -> jnp.ndarray:
    """Strassen product C = A @ B (ref ``strassen_multiply``,
    ``Multiplication/multi.cu``).  ``cutoff``: recursion stops at/below
    this size and uses one matrix product directly."""
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    return _strassen(a, b, cutoff)
