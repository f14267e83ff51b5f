"""Batched GP hyper-parameter fitting — maximize the log marginal likelihood.

Beyond-parity capability: the reference's GP pipelines take the kernel
matrix B and noise diagonal c as FIXED inputs (``calcluateMean``,
``src/gauss_bench.cu:127-265``) — there is no way to fit them to data.
This module closes the workflow: per system in the batch it learns scale
parameters θ = (log amplitude, log noise) of

    K(θ) = e^{2·θ_a} · B + diag(e^{2·θ_n} · c)

by maximizing :func:`..models.gp.gp_log_marginal_likelihood` of the
observations d with Adam (optax).

The entire optimization is ONE jitted ``lax.scan`` over update steps —
each step is a batched Cholesky + triangular inverse plus an O(batch)
parameter update, with no host round-trips and no per-step dispatch.
Gradients come from the analytic custom VJP of
:func:`..models.gp.gp_log_marginal_likelihood_vjp` (one batched WᵀW
product on the forward's residuals; faster than ``jax.grad`` through the
Cholesky and triangular-solve rules, which stays the tests' reference);
the batch dimension is native (systems are independent, so the summed
loss decouples per system).  Multi-device:
shard the batch axis exactly like the prediction pipelines
(``parallel/sharded.py``) — the fit has no cross-system collectives.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from cuda_matrix_inversion_tpu.models.gp import gp_log_marginal_likelihood_vjp


class GPFitResult(NamedTuple):
    """Outcome of :func:`fit_gp_scales` (all leaves device arrays).

    log_amp / log_noise — (batch,) learned per-system scales.
    lml — (batch,) final log marginal likelihood per system.
    lml_path — (steps,) batch-mean LML per step (convergence trace).
    """

    log_amp: jnp.ndarray
    log_noise: jnp.ndarray
    lml: jnp.ndarray
    lml_path: jnp.ndarray


def apply_scales(b, c, log_amp, log_noise):
    """Scaled kernel pieces (b̂, ĉ) such that B̂ + diag ĉ = K(θ).

    Feed these to the existing prediction pipelines
    (:func:`..models.gp.gp_mean_variance` et al.) to predict under the
    learned kernel — the pipelines stay single-kernel-launch.
    """
    amp2 = jnp.exp(2.0 * log_amp)[:, None, None]
    noise2 = jnp.exp(2.0 * log_noise)[:, None, None]
    return b * amp2, c * noise2


def _batch_lml(theta, b, c, d):
    """Per-system LML under θ — (batch,)."""
    b_hat, c_hat = apply_scales(b, c, theta[:, 0], theta[:, 1])
    return gp_log_marginal_likelihood_vjp(b_hat, c_hat, d)


@partial(jax.jit, static_argnames=("steps", "lr"))
def fit_gp_scales(b, c, d, steps: int = 150, lr: float = 0.05,
                  theta0=None, weights=None) -> GPFitResult:
    """Fit (log_amp, log_noise) per system by Adam on −LML.

    Shapes: b — (batch, n, n) SPD; c, d — (batch, n, 1);
    ``theta0`` — optional (batch, 2) initial (log_amp, log_noise),
    default zeros (i.e. start from the input scales).
    ``weights`` — optional (batch,) loss weights; systems with weight 0
    (e.g. the sharded wrapper's inert mesh padding) get exactly zero
    gradient, so their θ stays at the init and their LML stays finite,
    and they drop out of ``lml_path`` (the weighted-mean trace).

    The loss is the weighted mean of −LML; because systems share no
    parameters the per-system gradients are exact regardless of the
    reduction.  The optimizer loop is a ``lax.scan`` — compiler-visible,
    unrolled into a single XLA while op, nothing data-dependent on the
    host.
    """
    batch = b.shape[0]
    theta = (jnp.zeros((batch, 2), dtype=b.dtype) if theta0 is None
             else jnp.asarray(theta0, dtype=b.dtype))
    w = (jnp.ones((batch,), b.dtype) if weights is None
         else jnp.asarray(weights, dtype=b.dtype))
    wsum = jnp.maximum(jnp.sum(w), jnp.ones((), b.dtype))
    opt = optax.adam(lr)
    loss_fn = lambda t: -(jnp.sum(w * _batch_lml(t, b, c, d))
                          / wsum)

    def step(carry, _):
        t, opt_state = carry
        loss, grad = jax.value_and_grad(loss_fn)(t)
        updates, opt_state = opt.update(grad, opt_state, t)
        t = optax.apply_updates(t, updates)
        return (t, opt_state), -loss  # weighted-mean LML this step

    (theta, _), lml_path = jax.lax.scan(
        step, (theta, opt.init(theta)), None, length=steps)
    return GPFitResult(log_amp=theta[:, 0], log_noise=theta[:, 1],
                       lml=_batch_lml(theta, b, c, d),
                       lml_path=lml_path)


def fit_gp_scales_host(b, c, d, steps: int = 150, lr: float = 0.05,
                       theta0=None, weights=None) -> GPFitResult:
    """NumPy-in/NumPy-out flavor (analog of the ``*_gpu`` host wrappers)."""
    res = fit_gp_scales(*(jnp.asarray(x) for x in (b, c, d)),
                        steps=steps, lr=lr, theta0=theta0, weights=weights)
    return GPFitResult(*(np.asarray(jax.device_get(x)) for x in res))
