"""Tests for the XLA device ops and the GP model pipelines."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
from cuda_matrix_inversion_tpu.io.mats import read_test_folder
from cuda_matrix_inversion_tpu.models import gp
from cuda_matrix_inversion_tpu.ops import xla as ops
from cuda_matrix_inversion_tpu.ops.host_api import inverse_batched


def _identity_err(a, a_inv):
    prod = np.asarray(a, dtype=np.float64) @ np.asarray(a_inv, dtype=np.float64)
    return np.abs(prod - np.eye(a.shape[-1])).max()


def test_add_diagonal(rng):
    b = rng.standard_normal((4, 8, 8)).astype(np.float32)
    c = rng.standard_normal((4, 8, 1)).astype(np.float32)
    out = np.asarray(ops.add_diagonal(jnp.asarray(b), jnp.asarray(c)))
    expect = b + np.eye(8, dtype=np.float32) * c[:, :, 0][:, None, :]
    np.testing.assert_allclose(out, expect, atol=1e-7)


@pytest.mark.parametrize("alg", ["lu", "cholesky"])
@pytest.mark.parametrize("n", [8, 16, 64])
def test_batched_inverse_algorithms(alg, n, rng):
    a = make_spd_batch(8, n, rng).astype(np.float32)
    inv = inverse_batched(a, algorithm=alg)
    assert inv.shape == a.shape
    assert _identity_err(a, inv) < 1e-4  # the BASELINE gate


@pytest.mark.parametrize("alg", ["lu", "cholesky"])
def test_batched_inverse_fp64(alg, rng):
    a = make_spd_batch(4, 32, rng)
    inv = inverse_batched(a, algorithm=alg)
    assert _identity_err(a, inv) < 1e-11


def test_spd_solve_matches_inverse(rng):
    a = make_spd_batch(5, 16, rng).astype(np.float32)
    rhs = rng.standard_normal((5, 16, 2)).astype(np.float32)
    x1 = np.asarray(ops.spd_solve(jnp.asarray(a), jnp.asarray(rhs)))
    x2 = np.linalg.solve(a.astype(np.float64), rhs.astype(np.float64))
    np.testing.assert_allclose(x1, x2, atol=1e-3)


@pytest.mark.parametrize("method", ["solve", "inverse", "lu"])
def test_gp_pipeline_matches_fixtures(fixture_root, method):
    data = read_test_folder(os.path.join(fixture_root, "gaussian_20_16x16"), dtype=np.float32)
    mean, var = gp.gp_mean_variance_host(
        data["a"], data["b"], data["c"], data["d"], data["e"], method=method
    )
    assert np.abs(mean - data["means"]).max() < 1e-4
    assert np.abs(var - data["variances"]).max() < 1e-4


def test_gp_mean_and_variance_separate_entry_points(fixture_root):
    data = read_test_folder(os.path.join(fixture_root, "gaussian_20_8x8"), dtype=np.float32)
    mean = gp.gp_mean_host(data["a"], data["b"], data["c"], data["d"])
    var = gp.gp_variance_host(data["a"], data["b"], data["c"], data["e"])
    assert np.abs(mean - data["means"]).max() < 1e-4
    assert np.abs(var - data["variances"]).max() < 1e-4


def test_registry_lists_core_algorithms():
    from cuda_matrix_inversion_tpu.ops.registry import list_inverse_algorithms

    algs = list_inverse_algorithms()
    for required in ("lu", "cholesky", "lu_cpu", "cholesky_cpu", "gauss_cpu"):
        assert required in algs


def test_solve_batched_methods(rng):
    # the public solve API (ref GAUSS_SOLVE capability, gauss_cpu.c:118-131)
    from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
    from cuda_matrix_inversion_tpu.ops.host_api import solve_batched

    a = make_spd_batch(6, 16, rng).astype(np.float32)
    rhs = rng.standard_normal((6, 16, 3)).astype(np.float32)
    ref = np.linalg.solve(a.astype(np.float64), rhs.astype(np.float64))
    for method in ("lu", "cholesky", "lu_cpu", "cholesky_cpu"):
        x = solve_batched(a, rhs, method=method)
        assert x.shape == rhs.shape
        np.testing.assert_allclose(x, ref, atol=1e-4)
    # 2-D rhs round-trips without the trailing axis
    x2 = solve_batched(a, rhs[..., 0], method="lu")
    assert x2.shape == (6, 16)
    np.testing.assert_allclose(x2, ref[..., 0], atol=1e-4)
    import pytest as _pytest

    with _pytest.raises(KeyError, match="unknown solve method"):
        solve_batched(a, rhs, method="qr")


def test_solve_batched_exported():
    import cuda_matrix_inversion_tpu as cmi

    assert callable(cmi.solve_batched) and callable(cmi.inverse_batched)


def test_inverse_lu_large_n_polished_gate(rng):
    # r2: the raw fp32 LU expander drifts to ~1e-3 by n~512; the Newton
    # residual-polish step in ops/xla.py::inverse_lu restores the 1e-4
    # gate on the general-matrix large-n route (nonsymmetric input).
    from cuda_matrix_inversion_tpu.ops import xla

    n = 384
    a = rng.standard_normal((2, n, n)).astype(np.float32)
    a += n * np.eye(n, dtype=np.float32)
    a[:, : n // 2, :] *= 0.03  # uneven row scaling: nonsymmetric, worse kappa
    x = np.asarray(xla.inverse_lu(jnp.asarray(a)))
    err = np.abs(a.astype(np.float64) @ x - np.eye(n)).sum(-1).max()
    assert err < 1e-4
    # singular input still propagates non-finite through the polish
    s = np.ones((1, 256, 256), np.float32)
    xs = np.asarray(xla.inverse_lu(jnp.asarray(s)))
    assert not np.isfinite(xs).all()


def test_spd_logdet_matches_slogdet(rng):
    a = make_spd_batch(6, 32, rng).astype(np.float32)
    out = np.asarray(ops.spd_logdet(jnp.asarray(a)))
    _, expect = np.linalg.slogdet(a.astype(np.float64))
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-4)


def test_lu_logdet_general_with_sign(rng):
    g = rng.standard_normal((6, 16, 16)).astype(np.float32)
    sign, logdet = (np.asarray(x) for x in ops.lu_logdet(jnp.asarray(g)))
    esign, elog = np.linalg.slogdet(g.astype(np.float64))
    np.testing.assert_allclose(sign, esign)
    np.testing.assert_allclose(logdet, elog, rtol=1e-3, atol=1e-3)


def test_gp_log_marginal_likelihood_closed_form(rng):
    batch, n = 5, 24
    b = make_spd_batch(batch, n, rng).astype(np.float32)
    c = rng.random((batch, n, 1), dtype=np.float32) + 0.5
    d = rng.standard_normal((batch, n, 1)).astype(np.float32)
    out = np.asarray(gp.gp_log_marginal_likelihood(*map(jnp.asarray, (b, c, d))))
    k = b.astype(np.float64) + np.eye(n) * c[:, :, 0][:, None, :]
    kinv = np.linalg.inv(k)
    quad = (np.transpose(d, (0, 2, 1)).astype(np.float64) @ kinv
            @ d.astype(np.float64))[:, 0, 0]
    _, logdet = np.linalg.slogdet(k)
    expect = -0.5 * (quad + logdet + n * np.log(2 * np.pi))
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-3)


def test_gp_log_marginal_likelihood_grad(rng):
    # kernel-learning composition: grad wrt the noise column exists and
    # matches a central difference in fp64 (x64 is enabled per-test via
    # the CPU backend config; here fp32 + loose tol suffices)
    import jax

    batch, n = 2, 8
    b = make_spd_batch(batch, n, rng).astype(np.float32)
    c = rng.random((batch, n, 1), dtype=np.float32) + 1.0
    d = rng.standard_normal((batch, n, 1)).astype(np.float32)

    def loss(cv):
        return jnp.sum(gp.gp_log_marginal_likelihood(
            jnp.asarray(b), cv, jnp.asarray(d)))

    g = np.asarray(jax.grad(loss)(jnp.asarray(c)))
    eps = 1e-2
    e0 = np.zeros_like(c)
    e0[0, 0, 0] = eps
    fd = (float(loss(jnp.asarray(c + e0))) - float(loss(jnp.asarray(c - e0)))) / (2 * eps)
    np.testing.assert_allclose(g[0, 0, 0], fd, rtol=2e-2, atol=2e-3)


def test_gp_mean_variance_multi_points(rng):
    # m test points against one training kernel == m single-point calls
    batch, n, m = 4, 16, 5
    b = make_spd_batch(batch, n, rng).astype(np.float32)
    c = rng.random((batch, n, 1), dtype=np.float32) + 0.5
    d = rng.standard_normal((batch, n, 1)).astype(np.float32)
    a = rng.standard_normal((batch, n, m)).astype(np.float32)
    e = rng.random((batch, m, 1), dtype=np.float32) + 1.0
    mean, var = gp.gp_mean_variance_multi(*map(jnp.asarray, (a, b, c, d, e)))
    assert mean.shape == (batch, m, 1) and var.shape == (batch, m, 1)
    for j in range(m):
        mj, vj = gp.gp_mean_variance(
            jnp.asarray(a[:, :, j:j + 1]), jnp.asarray(b), jnp.asarray(c),
            jnp.asarray(d), jnp.asarray(e[:, j:j + 1, :]))
        np.testing.assert_allclose(np.asarray(mean)[:, j, 0],
                                   np.asarray(mj)[:, 0, 0], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(var)[:, j, 0],
                                   np.asarray(vj)[:, 0, 0], rtol=1e-4,
                                   atol=1e-5)


def test_gp_multi_accepts_flagship_method_strings(rng):
    # every method string the single-point pipeline takes must work on
    # the multi-point path too (code-review r3)
    batch, n, m = 2, 16, 3
    b = make_spd_batch(batch, n, rng).astype(np.float32)
    c = rng.random((batch, n, 1), dtype=np.float32) + 0.5
    d = rng.standard_normal((batch, n, 1)).astype(np.float32)
    a = rng.standard_normal((batch, n, m)).astype(np.float32)
    e = rng.random((batch, m, 1), dtype=np.float32) + 1.0
    ref_mean, ref_var = gp.gp_mean_variance_multi(
        *map(jnp.asarray, (a, b, c, d, e)))
    for method in ("inverse", "lu", "newton_schulz"):
        mean, var = gp.gp_mean_variance_multi(
            *map(jnp.asarray, (a, b, c, d, e)), method=method)
        np.testing.assert_allclose(np.asarray(mean), np.asarray(ref_mean),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(np.asarray(var), np.asarray(ref_var),
                                   rtol=1e-3, atol=1e-4)
