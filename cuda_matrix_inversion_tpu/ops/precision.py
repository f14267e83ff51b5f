"""Pinned matrix-product algorithms.

Every product whose accuracy a κ domain or an accuracy gate rests on names
its algorithm here instead of ``lax.Precision``.  The named presets mean
the same thing on every backend; the ``Precision`` enum does not (on an
H100 ``DEFAULT`` and ``HIGH`` both mean one TF32 pass, ~2⁻¹¹ relative).
The CPU backend computes every float32 preset in full fp32.

* ``F32``     — IEEE fp32 products (CUDA cores on the GPU).
* ``BF16``    — one bf16 pass, fp32 accumulation (~2⁻⁹ relative).
* ``BF16_X3`` — three bf16 passes over the hi/lo operand split (~2⁻¹⁷).
* ``BF16_X6`` — six bf16 passes (~2⁻²⁴, fp32-class), on the tensor cores.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

F32 = lax.DotAlgorithmPreset.F32_F32_F32
BF16 = lax.DotAlgorithmPreset.BF16_BF16_F32
BF16_X3 = lax.DotAlgorithmPreset.BF16_BF16_F32_X3
BF16_X6 = lax.DotAlgorithmPreset.BF16_BF16_F32_X6


def matmul(x, y, algorithm=F32):
    """``x @ y`` with the product algorithm pinned.

    The presets take float32 operands.  float64 operands run native f64
    products (``Precision.HIGHEST``), which no float32 preset matches.
    """
    if x.dtype == jnp.float64 or y.dtype == jnp.float64:
        return jnp.matmul(x, y, precision=lax.Precision.HIGHEST)
    return jnp.matmul(x, y, precision=algorithm,
                      preferred_element_type=jnp.float32).astype(
                          jnp.result_type(x, y))
