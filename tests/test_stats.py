"""Tests for ops/stats.py (reference src/inverse.c:26-48 helpers)."""

import numpy as np

from cuda_matrix_inversion_tpu.ops import stats


def test_column_mean(rng):
    x = rng.standard_normal((50, 7)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(stats.column_mean(x)), x.mean(0), atol=1e-6)


def test_subtract_column_mean(rng):
    x = rng.standard_normal((50, 7)).astype(np.float32)
    c = np.asarray(stats.subtract_column_mean(x))
    np.testing.assert_allclose(c.mean(0), 0, atol=1e-6)


def test_covariance_matches_numpy(rng):
    x = rng.standard_normal((200, 5)).astype(np.float32)
    cov = np.asarray(stats.covariance(x, ddof=1))
    expect = np.cov(x.T, ddof=1)
    np.testing.assert_allclose(cov, expect, atol=1e-4)


def test_covariance_batched(rng):
    x = rng.standard_normal((3, 40, 4)).astype(np.float32)
    cov = np.asarray(stats.covariance(x, ddof=0))
    for k in range(3):
        xc = x[k] - x[k].mean(0)
        np.testing.assert_allclose(cov[k], xc.T @ xc / 40, atol=1e-5)


def test_membench_ici_probe_on_virtual_mesh():
    from cuda_matrix_inversion_tpu.bench.membench import d2d_ring_bandwidth

    bw = d2d_ring_bandwidth(1 << 12)
    assert bw > 0
