"""Batched GP hyper-parameter fitting (models/gp_fit.py).

Synthetic recovery: draw observations from a KNOWN scaled kernel
K* = amp²·B + diag(noise²·c), fit θ from a neutral start, and check the
optimizer (a) increases the marginal likelihood, (b) recovers the
generating scales to reasonable statistical accuracy, and (c) the learned
kernel predicts better than the unscaled one.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cuda_matrix_inversion_tpu.models import gp, gp_fit


@pytest.fixture
def synth(rng):
    # low-rank-plus-diagonal kernel: B = W Wᵀ + 0.05 I with rank 6 ≪ n, so
    # the amplitude (scales the rank-6 signal subspace) and the noise
    # (scales the diagonal) are separately identifiable — a
    # diagonally-dominant B (make_spd_batch) puts both parameters on the
    # same diagonal ridge and the fit cannot distinguish them
    batch, n, rank = 16, 48, 6
    true_la, true_ln = np.log(1.8), np.log(0.5)
    w = rng.standard_normal((batch, n, rank))
    b = (w @ np.transpose(w, (0, 2, 1))
         + 0.05 * np.eye(n)).astype(np.float32)
    c = (rng.random((batch, n, 1)) + 0.5).astype(np.float32)
    k = (np.exp(2 * true_la) * b.astype(np.float64)
         + np.exp(2 * true_ln) * np.eye(n) * c[:, :, 0][:, None, :])
    l = np.linalg.cholesky(k)
    d = (l @ rng.standard_normal((batch, n, 1))).astype(np.float32)
    return b, c, d, true_la, true_ln


def test_fit_recovers_generating_scales(synth):
    b, c, d, true_la, true_ln = synth
    res = gp_fit.fit_gp_scales_host(b, c, d, steps=250, lr=0.05)
    # LML improves over the fit and ends at its max region
    assert res.lml_path[-1] > res.lml_path[0] + 1.0
    assert res.lml_path.shape == (250,)
    # batch-mean recovery: single-draw-per-system estimates are noisy
    # individually but average out over 16 systems
    assert abs(res.log_amp.mean() - true_la) < 0.25
    assert abs(res.log_noise.mean() - true_ln) < 0.4
    # optimization correctness independent of identifiability: the fit
    # must reach at least the generating parameters' own likelihood
    theta_star = np.broadcast_to(
        np.array([true_la, true_ln], np.float32), (b.shape[0], 2))
    lml_star = np.asarray(gp_fit._batch_lml(
        jnp.asarray(theta_star), *map(jnp.asarray, (b, c, d))))
    assert res.lml.mean() >= lml_star.mean() - 0.5


def test_fitted_kernel_beats_unscaled_lml(synth):
    b, c, d, _, _ = synth
    res = gp_fit.fit_gp_scales_host(b, c, d, steps=150, lr=0.05)
    lml0 = np.asarray(gp.gp_log_marginal_likelihood(
        *map(jnp.asarray, (b, c, d))))
    # per-system: the learned scales dominate the neutral start
    assert (res.lml >= lml0 - 1e-3).all()
    assert res.lml.mean() > lml0.mean() + 1.0


def test_apply_scales_feeds_prediction_pipeline(synth):
    b, c, d, _, _ = synth
    res = gp_fit.fit_gp_scales_host(b, c, d, steps=60, lr=0.05)
    b_hat, c_hat = gp_fit.apply_scales(
        jnp.asarray(b), jnp.asarray(c),
        jnp.asarray(res.log_amp), jnp.asarray(res.log_noise))
    batch, n = b.shape[0], b.shape[1]
    a = jnp.asarray(np.random.default_rng(3).standard_normal(
        (batch, n, 1)).astype(np.float32))
    e = jnp.ones((batch, 1, 1), jnp.float32) * 2.0
    mean, var = gp.gp_mean_variance(a, b_hat, c_hat, jnp.asarray(d), e)
    assert np.isfinite(np.asarray(mean)).all()
    assert np.isfinite(np.asarray(var)).all()


gp_log_marginal_likelihood_fused = gp.gp_log_marginal_likelihood_vjp


def test_fused_lml_matches_xla(synth):
    b, c, d, _, _ = synth
    fused = np.asarray(gp_log_marginal_likelihood_fused(
        *map(jnp.asarray, (b, c, d))))
    ref = np.asarray(gp.gp_log_marginal_likelihood(
        *map(jnp.asarray, (b, c, d))))
    np.testing.assert_allclose(fused, ref, rtol=1e-4, atol=1e-3)


def test_fused_lml_odd_n_padding(rng):
    # n = 11: value and gradients of the custom-VJP LML at an odd width
    batch, n = 5, 11
    w = rng.standard_normal((batch, n, 3))
    b = (w @ np.transpose(w, (0, 2, 1)) + 0.1 * np.eye(n)).astype(np.float32)
    c = (rng.random((batch, n, 1)) + 0.5).astype(np.float32)
    d = rng.standard_normal((batch, n, 1)).astype(np.float32)
    fused = np.asarray(gp_log_marginal_likelihood_fused(
        *map(jnp.asarray, (b, c, d))))
    ref = np.asarray(gp.gp_log_marginal_likelihood(
        *map(jnp.asarray, (b, c, d))))
    np.testing.assert_allclose(fused, ref, rtol=1e-4, atol=1e-3)
    import jax

    for argnum in (1, 2):
        gf = jax.grad(lambda *a: jnp.sum(gp_log_marginal_likelihood_fused(
            *a)), argnums=argnum)(*map(jnp.asarray, (b, c, d)))
        gx = jax.grad(lambda *a: jnp.sum(gp.gp_log_marginal_likelihood(
            *a)), argnums=argnum)(*map(jnp.asarray, (b, c, d)))
        np.testing.assert_allclose(np.asarray(gf), np.asarray(gx),
                                   rtol=2e-3, atol=2e-3)


def test_fused_lml_analytic_gradients_match_xla(synth):
    # the custom VJP (alpha/K-inverse formulae) must agree with autodiff
    # through the XLA cholesky chain; c and d gradients are unambiguous,
    # and the theta chain (symmetric directions through apply_scales)
    # checks the b gradient's action where it matters for the fit
    import jax

    b, c, d, _, _ = synth
    bb, cc, dd = map(jnp.asarray, (b, c, d))

    for argnum, tol in ((1, 2e-3), (2, 2e-3)):
        gf = jax.grad(lambda *a: jnp.sum(
            gp_log_marginal_likelihood_fused(*a)), argnums=argnum)(bb, cc, dd)
        gx = jax.grad(lambda *a: jnp.sum(
            gp.gp_log_marginal_likelihood(*a)), argnums=argnum)(bb, cc, dd)
        np.testing.assert_allclose(np.asarray(gf), np.asarray(gx),
                                   rtol=tol, atol=tol)

    theta = jnp.full((b.shape[0], 2), 0.1, jnp.float32)
    gt_f = jax.grad(lambda t: jnp.sum(gp_fit._batch_lml(
        t, bb, cc, dd)))(theta)
    gt_x = jax.grad(lambda t: jnp.sum(_xla_batch_lml(t, bb, cc, dd)))(theta)
    np.testing.assert_allclose(np.asarray(gt_f), np.asarray(gt_x),
                               rtol=2e-3, atol=2e-3)


def _xla_batch_lml(theta, b, c, d):
    # reference LML: jax.grad differentiates through the Cholesky chain
    b_hat, c_hat = gp_fit.apply_scales(b, c, theta[:, 0], theta[:, 1])
    return gp.gp_log_marginal_likelihood(b_hat, c_hat, d)


def test_fit_method_pallas_matches_xla(synth):
    # the fit (custom-VJP gradients) against the same Adam loop driven by
    # jax.grad of the reference LML
    import jax
    import optax

    b, c, d, _, _ = synth
    bb, cc, dd = map(jnp.asarray, (b, c, d))
    opt = optax.adam(0.05)
    theta = jnp.zeros((b.shape[0], 2), jnp.float32)
    state = opt.init(theta)
    grad = jax.jit(jax.grad(
        lambda t: -jnp.mean(_xla_batch_lml(t, bb, cc, dd))))
    for _ in range(60):
        updates, state = opt.update(grad(theta), state, theta)
        theta = optax.apply_updates(theta, updates)
    res_x_lml = np.asarray(_xla_batch_lml(theta, bb, cc, dd))
    res_p = gp_fit.fit_gp_scales_host(b, c, d, steps=60, lr=0.05)
    np.testing.assert_allclose(res_p.lml, res_x_lml, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(res_p.log_amp, np.asarray(theta[:, 0]),
                               atol=5e-3)
    np.testing.assert_allclose(res_p.log_noise, np.asarray(theta[:, 1]),
                               atol=5e-3)


def test_gauss_bench_fit_rows(fixture_root):
    import io
    import os

    from cuda_matrix_inversion_tpu.bench.gauss_bench import run_bench

    out = io.StringIO()
    run_bench(os.path.join(fixture_root, "gaussian_20_8x8"), 1, 1, csv=True,
              skip_cpu=True, fit=True, stream=out)
    lines = out.getvalue().strip().splitlines()
    fit_rows = {l.split()[3]: l for l in lines if "fit_step" in l}
    assert set(fit_rows) == {"fit_step_xla", "fit_step_vjp"}
    # error column of the vjp row = total |grad diff| vs the XLA
    # oracle, reported per matrix like every other row
    assert float(fit_rows["fit_step_vjp"].split()[-1]) < 1e-4


def test_theta0_warm_start(synth):
    b, c, d, _, _ = synth
    cold = gp_fit.fit_gp_scales_host(b, c, d, steps=40, lr=0.05)
    theta0 = np.stack([cold.log_amp, cold.log_noise], axis=1)
    warm = gp_fit.fit_gp_scales_host(b, c, d, steps=40, lr=0.05,
                                     theta0=theta0)
    assert warm.lml.mean() >= cold.lml.mean() - 1e-3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("argnum", [0, 1, 2])
def test_lml_custom_vjp_matches_jax_grad(argnum, dtype, rng):
    # the analytic rule (∂/∂K = ½(ααᵀ − K⁻¹), ∂/∂d = −α) against autodiff
    # through the Cholesky chain, per argument; ∂/∂B is compared on its
    # symmetric part — the only part a symmetric perturbation of B sees
    import jax

    batch, n = 4, 24
    w = rng.standard_normal((batch, n, 5))
    b = (w @ np.transpose(w, (0, 2, 1)) + 0.1 * np.eye(n)).astype(dtype)
    c = (rng.random((batch, n, 1)) + 0.5).astype(dtype)
    d = rng.standard_normal((batch, n, 1)).astype(dtype)
    args = tuple(map(jnp.asarray, (b, c, d)))
    g_vjp = jax.grad(lambda *a: jnp.sum(gp.gp_log_marginal_likelihood_vjp(*a)),
                     argnums=argnum)(*args)
    g_ad = jax.grad(lambda *a: jnp.sum(gp.gp_log_marginal_likelihood(*a)),
                    argnums=argnum)(*args)
    g_vjp, g_ad = np.asarray(g_vjp), np.asarray(g_ad)
    if argnum == 0:
        g_vjp = (g_vjp + np.swapaxes(g_vjp, -1, -2)) / 2
        g_ad = (g_ad + np.swapaxes(g_ad, -1, -2)) / 2
    tol = 2e-3 if dtype == np.float32 else 1e-9
    np.testing.assert_allclose(g_vjp, g_ad, rtol=tol, atol=tol)
    assert g_vjp.dtype == dtype
