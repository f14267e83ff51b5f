"""Tests for the Gauss-Jordan oracle (``cpu_reference``, the reference's
pivoting algorithm) and the GP mean/variance routes: the one-jit-region
solve pipeline and the warm Newton-Schulz route (its kernel in the Pallas
interpreter on the CPU backend)."""

import numpy as np
import pytest

from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
from cuda_matrix_inversion_tpu.models.gp import gp_mean_variance
from cuda_matrix_inversion_tpu.ops.cpu_reference import inverse_gauss_jordan


def gp_mean_variance_fused(a, b, c, d, e):
    return gp_mean_variance(a, b, c, d, e, method="solve")


def gp_mean_variance_fused_ns(a, b, c, d, e):
    """Warm route seeded with the float64 inverse of a 1e-3-drifted K."""
    from cuda_matrix_inversion_tpu.models.gp import gp_mean_variance_warm

    n = b.shape[-1]
    k = b.astype(np.float64) * 1.001 + np.eye(n) * c[:, :, 0][:, None, :]
    prev = np.linalg.inv(k).astype(np.float32)
    mean, var, _ = gp_mean_variance_warm(a, b, c, d, e, prev)
    return mean, var


def _identity_err_inf(a, a_inv):
    prod = np.asarray(a, dtype=np.float64) @ np.asarray(a_inv, dtype=np.float64)
    return np.abs(prod - np.eye(a.shape[-1])).sum(-1).max()


@pytest.mark.parametrize("n", [8, 16, 32])
def test_gj_spd(n, rng):
    a = make_spd_batch(6, n, rng).astype(np.float32)
    inv = np.asarray(inverse_gauss_jordan(a))
    assert _identity_err_inf(a, inv) < 1e-4


def test_gj_requires_pivoting():
    # zero diagonal: the reference's GJ only survives this via its
    # first-nonzero scan (batched_invert.cu:19-35); ours must too.
    a = np.array([[[0.0, 1.0], [1.0, 0.0]]], dtype=np.float32)
    inv = np.asarray(inverse_gauss_jordan(a))
    np.testing.assert_allclose(inv[0], [[0, 1], [1, 0]], atol=1e-6)


def test_gj_magnitude_pivoting_stability():
    # tiny-but-nonzero diagonal: the reference would NOT pivot here and
    # lose all precision; magnitude pivoting keeps the answer exact-ish.
    a = np.array([[[1e-7, 1.0], [1.0, 1.0]]], dtype=np.float32)
    inv = np.asarray(inverse_gauss_jordan(a))
    assert _identity_err_inf(a, inv) < 1e-5


def test_gj_general_nonsymmetric(rng):
    g = rng.standard_normal((8, 24, 24)).astype(np.float32)
    inv = np.asarray(inverse_gauss_jordan(g))
    assert _identity_err_inf(g, inv) < 1e-2  # random matrices: modest kappa


def test_gj_mixed_batch_pivot_divergence(rng):
    # each matrix picks a different pivot row at step 0 — exercises the
    # per-matrix one-hot swap logic
    base = make_spd_batch(4, 8, rng).astype(np.float32)
    perms = [np.eye(8)[np.random.default_rng(i).permutation(8)] for i in range(4)]
    a = np.stack([p @ b for p, b in zip(perms, base)]).astype(np.float32)
    inv = np.asarray(inverse_gauss_jordan(a))
    assert _identity_err_inf(a, inv) < 1e-4


# ---------------- GP routes ----------------

def _gp_ref(a, b, c, d, e):
    n = b.shape[1]
    k = b.astype(np.float64) + np.eye(n) * c[:, :, 0][:, None, :]
    kinv = np.linalg.inv(k)
    mean = np.transpose(a, (0, 2, 1)) @ (kinv @ d)
    var = e - np.transpose(a, (0, 2, 1)) @ (kinv @ a)
    return mean, var


@pytest.mark.parametrize("n", [16, 64])
def test_fused_gp_kernel(n, rng):
    batch = 6
    b = make_spd_batch(batch, n, rng).astype(np.float32)
    a = rng.random((batch, n, 1), dtype=np.float32)
    c = rng.random((batch, n, 1), dtype=np.float32)
    d = rng.random((batch, n, 1), dtype=np.float32)
    e = rng.random((batch, 1, 1), dtype=np.float32)
    mean, var = gp_mean_variance_fused(a, b, c, d, e)
    mref, vref = _gp_ref(a, b, c, d, e)
    assert np.abs(np.asarray(mean) - mref).max() < 1e-4
    assert np.abs(np.asarray(var) - vref).max() < 1e-4


def test_fused_gp_batch_padding(rng):
    # batch size that does not divide the block
    batch, n = 5, 16
    b = make_spd_batch(batch, n, rng).astype(np.float32)
    a = rng.random((batch, n, 1), dtype=np.float32)
    c = rng.random((batch, n, 1), dtype=np.float32)
    d = rng.random((batch, n, 1), dtype=np.float32)
    e = rng.random((batch, 1, 1), dtype=np.float32)
    from cuda_matrix_inversion_tpu.engine import GPEngine

    mean, var = GPEngine(batch_buckets=(8,)).mean_variance(a, b, c, d, e)
    mref, vref = _gp_ref(a, b, c, d, e)
    assert mean.shape == (batch, 1, 1)
    assert np.abs(np.asarray(mean) - mref).max() < 1e-4
    assert np.abs(np.asarray(var) - vref).max() < 1e-4


def test_gp_model_pallas_method(fixture_root):
    import os

    from cuda_matrix_inversion_tpu.io.mats import read_test_folder
    from cuda_matrix_inversion_tpu.models import gp

    data = read_test_folder(os.path.join(fixture_root, "gaussian_20_16x16"), dtype=np.float32)
    mean, var = gp.gp_mean_variance(
        *(np.asarray(data[k]) for k in "abcde"), method="lu")
    assert np.abs(np.asarray(mean) - data["means"]).max() < 1e-4
    assert np.abs(np.asarray(var) - data["variances"]).max() < 1e-4


@pytest.mark.parametrize("n", [16, 64, 160])
def test_fused_gp_ns_kernel(n, rng):
    batch = 6
    b = make_spd_batch(batch, n, rng).astype(np.float32)
    a = rng.random((batch, n, 1), dtype=np.float32)
    c = rng.random((batch, n, 1), dtype=np.float32)
    d = rng.random((batch, n, 1), dtype=np.float32)
    e = rng.random((batch, 1, 1), dtype=np.float32)
    mean, var = gp_mean_variance_fused_ns(a, b, c, d, e)
    mref, vref = _gp_ref(a, b, c, d, e)
    assert np.abs(np.asarray(mean) - mref).max() < 1e-4
    assert np.abs(np.asarray(var) - vref).max() < 1e-4


def test_gp_model_pallas_ns_method(fixture_root):
    import os

    from cuda_matrix_inversion_tpu.io.mats import read_test_folder
    from cuda_matrix_inversion_tpu.models import gp

    data = read_test_folder(os.path.join(fixture_root, "gaussian_20_16x16"), dtype=np.float32)
    mean, var = gp.gp_mean_variance(
        *(np.asarray(data[k]) for k in "abcde"), method="newton_schulz")
    assert np.abs(np.asarray(mean) - data["means"]).max() < 1e-4
    assert np.abs(np.asarray(var) - data["variances"]).max() < 1e-4


def test_fused_gp_odd_n_padding(rng):
    # n = 12 pads to the kernel's power-of-two width (identity block) on
    # the warm route; the solve route takes it as is
    batch, n = 4, 12
    b = make_spd_batch(batch, n, rng).astype(np.float32)
    a = rng.random((batch, n, 1), dtype=np.float32)
    c = rng.random((batch, n, 1), dtype=np.float32)
    d = rng.random((batch, n, 1), dtype=np.float32)
    e = rng.random((batch, 1, 1), dtype=np.float32)
    mref, vref = _gp_ref(a, b, c, d, e)
    for fn in (gp_mean_variance_fused, gp_mean_variance_fused_ns):
        mean, var = fn(a, b, c, d, e)
        assert mean.shape == (batch, 1, 1)
        assert np.abs(np.asarray(mean) - mref).max() < 1e-4
        assert np.abs(np.asarray(var) - vref).max() < 1e-4
