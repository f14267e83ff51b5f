"""The Newton-Schulz lanes: the Triton kernel (in the Pallas interpreter on
the CPU backend), its plain-XLA twin, padding, routing and warm starts,
against the float64 LAPACK reference."""

import numpy as np
import pytest

from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch, make_square_batch
from cuda_matrix_inversion_tpu.ops import cpu_reference
from cuda_matrix_inversion_tpu.ops import newton_schulz as ns
from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

SIZES = (8, 16, 32, 64, 128, 160)
LANES = {
    "newton_schulz_pallas": {},
    "newton_schulz_spd_pallas": {"init": "spd"},
    "newton_schulz_spd10_pallas": {"init": "spd", "lo_iters": 4,
                                   "hi_iters": 2, "mu_min": 0.03},
    "newton_schulz_pan500_pallas": {"precision": "split3"},
}


def _resid(a, x):
    prod = np.asarray(a, np.float64) @ np.asarray(x, np.float64)
    return np.abs(prod - np.eye(a.shape[-1])).sum(-1).max()


def _close_to_lapack(a, x):
    ref = cpu_reference.inverse_lu(a.astype(np.float64))
    assert _resid(a, x) < 1e-4
    rel = np.abs(np.asarray(x, np.float64) - ref).max() / np.abs(ref).max()
    assert rel < 1e-3


@pytest.mark.parametrize("n", SIZES)
def test_spd_lane_matches_lapack(n, rng):
    a = make_spd_batch(3, n, rng).astype(np.float32)
    _close_to_lapack(a, get_inverse_algorithm("newton_schulz_spd_pallas")(a))


@pytest.mark.parametrize("n", SIZES)
def test_pan500_lane_general_matches_lapack(n, rng):
    a = make_square_batch(3, n, rng, kappa_cap=min(4.0 * n, 300.0)).astype(
        np.float32)
    _close_to_lapack(a, get_inverse_algorithm("newton_schulz_pan500_pallas")(a))


@pytest.mark.parametrize("n", SIZES)
def test_adaptive_general_matches_lapack(n, rng):
    a = make_square_batch(3, n, rng).astype(np.float32)
    _close_to_lapack(a, get_inverse_algorithm("newton_schulz")(a))


@pytest.mark.parametrize("lane", sorted(LANES))
def test_kernel_matches_plain_xla_schedule(lane, rng):
    # the kernel and the vmap'd XLA form run the same per-matrix
    # computation; on the CPU backend both are full fp32
    a = make_spd_batch(4, 64, rng).astype(np.float32)
    kernel = np.asarray(get_inverse_algorithm(lane)(a))
    plain = np.asarray(ns.inverse_newton_schulz_fixed(a, **LANES[lane]))
    np.testing.assert_allclose(kernel, plain, rtol=1e-5, atol=1e-7)
    assert _resid(a, kernel) < 1e-4


@pytest.mark.parametrize("n, width", [(1, 16), (8, 16), (16, 16), (17, 32),
                                      (33, 64), (100, 128), (128, 128)])
def test_kernel_width_is_power_of_two_at_least_16(n, width):
    assert ns._kernel_n(n) == width
    assert width in ns._NUM_WARPS


def test_identity_padding_is_exact(rng):
    # blockdiag(A, sI) with s = min(||A||_1, ||A||_inf): both norms, and so
    # both start scalings, are A's own, and the inverse slices back exactly
    a = make_square_batch(2, 12, rng).astype(np.float32)
    s = np.minimum(np.abs(a).sum(-1).max(-1), np.abs(a).sum(-2).max(-1))
    p = np.asarray(ns._pad_scaled_identity(a, 16))
    assert p.shape == (2, 16, 16)
    np.testing.assert_array_equal(p[:, :12, :12], a)
    np.testing.assert_allclose(p[:, 12:, 12:], s[:, None, None] * np.eye(4),
                               rtol=1e-6)
    assert not p[:, :12, 12:].any() and not p[:, 12:, :12].any()
    for norm_axis in (-1, -2):
        np.testing.assert_allclose(np.abs(p).sum(norm_axis).max(-1),
                                   np.abs(a).sum(norm_axis).max(-1), rtol=1e-6)
    inv = np.linalg.inv(p.astype(np.float64))
    np.testing.assert_allclose(inv[:, :12, :12],
                               np.linalg.inv(a.astype(np.float64)), rtol=1e-9)
    # a warm start pads with the pad block's own inverse
    pa, px = map(np.asarray, ns._pad_scaled_identity(a, 16, inv[:, :12, :12]))
    np.testing.assert_allclose(pa @ px.astype(np.float64),
                               np.broadcast_to(np.eye(16), (2, 16, 16)),
                               atol=1e-5)


@pytest.mark.parametrize("scale", [1e-5, 1e3])
@pytest.mark.parametrize("lane", sorted(LANES))
def test_padded_kernel_holds_gate_at_any_scale(lane, scale, rng):
    # n = 96 pads to 128: the pad block must not move the start scaling
    # away from A's own norm, whatever that norm is
    a = (scale * make_spd_batch(2, 96, rng)).astype(np.float32)
    x = get_inverse_algorithm(lane)(a)
    assert _resid(a, x) < 1e-4


@pytest.mark.parametrize("scale", [1e-5, 1e3])
def test_padded_warm_kernel_at_any_scale(scale, rng):
    a = (scale * make_spd_batch(2, 96, rng)).astype(np.float32)
    x0 = np.linalg.inv(a.astype(np.float64)).astype(np.float32)
    a2 = (a * (1.0 + 1e-3 * rng.standard_normal(a.shape))).astype(np.float32)
    x = ns.inverse_newton_schulz_warm(a2, x0)
    assert _resid(a2, x) < 1e-4


@pytest.mark.parametrize("n, kernel", [(8, True), (128, True), (129, False),
                                       (160, False)])
def test_routing_at_kernel_width(n, kernel, rng, monkeypatch):
    calls = []
    real = ns._per_matrix_call
    monkeypatch.setattr(ns, "_per_matrix_call",
                        lambda *a, **k: calls.append(a[1][0].shape) or real(*a, **k))
    a = make_spd_batch(2, n, rng).astype(np.float32)
    # __wrapped__ bypasses jit's trace cache so the routing runs here
    x = ns.inverse_newton_schulz_pallas.__wrapped__(a, init="spd")
    assert (len(calls) == 1) == kernel
    if kernel:
        assert calls[0] == (2, ns._kernel_n(n), ns._kernel_n(n))
    assert _resid(a, x) < 1e-4


def test_warm_routing_past_kernel_width(rng, monkeypatch):
    monkeypatch.setattr(ns, "_per_matrix_call",
                        lambda *a, **k: pytest.fail("kernel past its width"))
    a = make_spd_batch(2, 136, rng).astype(np.float32)
    x0 = np.linalg.inv(a.astype(np.float64) * 1.001).astype(np.float32)
    x = ns.inverse_newton_schulz_warm.__wrapped__(a, x0)
    assert _resid(a, x) < 1e-4


@pytest.mark.parametrize("precision", ["bf16", "split3"])
@pytest.mark.parametrize("n", [16, 100])
def test_warm_kernel_refines_drifted_batch(n, precision, rng):
    a = make_spd_batch(3, n, rng).astype(np.float32)
    x0 = np.linalg.inv(a.astype(np.float64)).astype(np.float32)
    a2 = (a * (1.0 + 1e-3 * rng.standard_normal(a.shape))).astype(np.float32)
    assert _resid(a2, x0) > 1e-3  # the start really is off
    x = ns.inverse_newton_schulz_warm(a2, x0, precision=precision)
    _close_to_lapack(a2, x)


@pytest.mark.parametrize("env, arg, expect", [("1", None, True),
                                              (None, None, False),
                                              ("1", False, False)])
def test_interpret_only_when_asked(env, arg, expect, monkeypatch):
    if env is None:
        monkeypatch.delenv(ns.INTERPRET_ENV, raising=False)
    else:
        monkeypatch.setenv(ns.INTERPRET_ENV, env)
    assert ns._interpret(arg) is expect


def test_uninterpreted_kernel_refuses_cpu(rng, monkeypatch):
    # never a silent interpreter: asked to compile, the kernel raises on
    # the CPU backend
    monkeypatch.delenv(ns.INTERPRET_ENV, raising=False)
    a = make_spd_batch(1, 8, rng).astype(np.float32)
    with pytest.raises(Exception, match="interpret"):
        ns.inverse_newton_schulz_pallas.__wrapped__(a, init="spd")


def test_kernel_empty_batch():
    out = ns.inverse_newton_schulz_pallas(np.zeros((0, 8, 8), np.float32))
    assert out.shape == (0, 8, 8)
