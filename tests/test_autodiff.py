"""Gradient tests for the differentiable inversion wrappers."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
from cuda_matrix_inversion_tpu.ops.autodiff import differentiable


@pytest.mark.parametrize("alg", ["newton_schulz", "cholesky", "lu",
                                 "newton_schulz_spd_pallas"])
def test_grad_matches_linalg_inv(alg, rng):
    inv = differentiable(alg)
    a = jnp.asarray(make_spd_batch(3, 8, rng).astype(np.float32))

    def loss_custom(a):
        return jnp.sum(inv(a) ** 2)

    def loss_ref(a):
        return jnp.sum(jnp.linalg.inv(a) ** 2)

    g1 = np.asarray(jax.grad(loss_custom)(a))
    g2 = np.asarray(jax.grad(loss_ref)(a))
    np.testing.assert_allclose(g1, g2, rtol=2e-2, atol=2e-4)


def test_grad_numerical_check(rng):
    inv = differentiable("newton_schulz")
    a = jnp.asarray(make_spd_batch(1, 4, rng).astype(np.float64).astype(np.float32))

    def loss(a):
        return inv(a)[0, 0, 0]

    g = np.asarray(jax.grad(loss)(a))[0]
    # central differences
    eps = 1e-2
    num = np.zeros((4, 4), np.float64)
    a_np = np.asarray(a, dtype=np.float64)[0]
    for i in range(4):
        for j in range(4):
            ap = a_np.copy(); ap[i, j] += eps
            am = a_np.copy(); am[i, j] -= eps
            num[i, j] = (np.linalg.inv(ap)[0, 0] - np.linalg.inv(am)[0, 0]) / (2 * eps)
    np.testing.assert_allclose(g, num, rtol=5e-2, atol=1e-3)


def test_jvp_via_transpose(rng):
    # custom_vjp also gives forward-over-reverse for hessian-vector uses
    inv = differentiable("newton_schulz")
    a = jnp.asarray(make_spd_batch(2, 4, rng).astype(np.float32))
    val, vjp_fn = jax.vjp(lambda x: inv(x), a)
    (g,) = vjp_fn(jnp.ones_like(val))
    assert np.isfinite(np.asarray(g)).all()


def test_gp_pipeline_differentiable(rng):
    # hyperparameter gradients through the GP pipeline (solve method uses
    # cholesky/triangular_solve, which have VJPs)
    from cuda_matrix_inversion_tpu.models.gp import gp_mean

    batch, n = 3, 8
    b = jnp.asarray(make_spd_batch(batch, n, rng).astype(np.float32))
    a = jnp.asarray(rng.random((batch, n, 1), dtype=np.float32))
    c = jnp.asarray(rng.random((batch, n, 1), dtype=np.float32))
    d = jnp.asarray(rng.random((batch, n, 1), dtype=np.float32))

    def loss(c):
        return jnp.sum(gp_mean(a, b, c, d, method="solve"))

    g = np.asarray(jax.grad(loss)(c))
    assert g.shape == c.shape and np.isfinite(g).all()
    # numerical check on one coordinate
    eps = 1e-2
    cp = np.asarray(c).copy(); cp[0, 0, 0] += eps
    cm = np.asarray(c).copy(); cm[0, 0, 0] -= eps
    num = (float(loss(jnp.asarray(cp))) - float(loss(jnp.asarray(cm)))) / (2 * eps)
    assert abs(num - g[0, 0, 0]) < 5e-2 * max(1.0, abs(num))
