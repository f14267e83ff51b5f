"""Large-n serving: the n > 128 routes of the fixed Newton-Schulz lanes
(plain XLA past the kernel's width), the GP pipeline and the engine's 512
bucket.
"""

import numpy as np

from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch


def _gate(a, inv):
    prod = np.asarray(a, np.float64) @ np.asarray(inv, np.float64)
    return np.abs(prod - np.eye(a.shape[-1])).max()


def test_newton_schulz_spd_serves_past_224(rng):
    from cuda_matrix_inversion_tpu.ops.newton_schulz import (
        inverse_newton_schulz_pallas,
    )

    a = make_spd_batch(1, 240, rng).astype(np.float32)
    inv = inverse_newton_schulz_pallas(a, init="spd")
    assert _gate(a, inv) < 1e-4


def test_newton_schulz_spd10_schur_route_inherits_schedule(rng):
    # ADVICE r2 (high): a large-n route once dropped mu_min /
    # polish_highest, so the spd10 lane (lo=4, calibrated for mu_min=0.03)
    # ran scaled-round coefficients computed for mu_min=0.01 — gate 2.1e-4
    # at kappa=8 in fp32.  Pin it: the registered spd10 entry must pass
    # the gate at n=240, kappa=8, where the XLA fixed schedule serves it.
    from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

    q, _ = np.linalg.qr(rng.standard_normal((1, 240, 240)))
    lam = np.logspace(0, -np.log10(8.0), 240)
    a = ((q * lam[None, None, :]) @ np.transpose(q, (0, 2, 1))).astype(
        np.float32)
    fn = get_inverse_algorithm("newton_schulz_spd10_pallas")
    assert _gate(a, np.asarray(fn(a))) < 1e-4


def test_gp_fused_past_256(rng):
    n, batch = 264, 1
    b = make_spd_batch(batch, n, rng).astype(np.float32)
    a = rng.random((batch, n, 1), dtype=np.float32)
    c = rng.random((batch, n, 1), dtype=np.float32)
    d = rng.random((batch, n, 1), dtype=np.float32)
    e = rng.random((batch, 1, 1), dtype=np.float32)

    from cuda_matrix_inversion_tpu.models.gp import gp_mean_variance

    mean, var = gp_mean_variance(a, b, c, d, e)
    k = b.astype(np.float64) + np.eye(n) * c[:, :, 0][:, None, :]
    kinv = np.linalg.inv(k)
    mref = np.transpose(a, (0, 2, 1)) @ (kinv @ d)
    vref = e - np.transpose(a, (0, 2, 1)) @ (kinv @ a)
    np.testing.assert_allclose(np.asarray(mean), mref, atol=1e-4)
    np.testing.assert_allclose(np.asarray(var), vref, atol=1e-4)


def test_engine_512_bucket_meets_gate(rng):
    # ADVICE r1 #2: the advertised 8..512 range must hold the 1e-4 gate
    from cuda_matrix_inversion_tpu.engine import InversionEngine

    eng = InversionEngine(algorithm="cholesky",
                          dim_buckets=(8, 64, 300))
    a = make_spd_batch(1, 280, rng).astype(np.float32)
    out = eng.inverse(a)
    assert _gate(a, out) < 1e-4
