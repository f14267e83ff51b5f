"""The XLA factorization routes (``lu``, ``cholesky``) against the float64
LAPACK reference (``ops/cpu_reference.py``) over matrix classes and sizes.

On the GPU these routes are cuSOLVER/cuBLAS batched getrf, potrf and trsm
through XLA; here they run on the CPU backend, which checks the wrappers
(fp32 polish, padding, dtype) and the semantics each class exercises.
"""

import numpy as np
import pytest

from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch, make_square_batch
from cuda_matrix_inversion_tpu.ops import cpu_reference
from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

SIZES = (8, 16, 32, 64, 128, 160)
GATE = 1e-4


def _resid(a, x):
    prod = np.asarray(a, np.float64) @ np.asarray(x, np.float64)
    return np.abs(prod - np.eye(a.shape[-1])).sum(-1).max()


def _batch(cls, n, rng):
    if cls == "spd":
        return make_spd_batch(3, n, rng).astype(np.float32)
    if cls == "general":  # κ ≤ 4n, sign-mixed: real partial pivoting
        return make_square_batch(3, n, rng).astype(np.float32)
    a = rng.standard_normal((3, n, n)).astype(np.float32)
    if cls == "permuted_rows":  # every column's pivot sits off the diagonal
        return a + n * np.eye(n, dtype=np.float32)[rng.permutation(n)]
    a = a + n * np.eye(n, dtype=np.float32)
    a[:, 0, 0] = 0.0  # needs_pivoting: a zero leading pivot
    return a


def _check(a, x):
    """The gate plus agreement with float64 LAPACK getrf/getri.  The
    general class reaches κ = 4n, so its fp32 gate is taken relative to
    fp32 LAPACK on the same draw (its residual grows with κ)."""
    ref = cpu_reference.inverse_lu(a.astype(np.float64))
    lapack32 = _resid(a, cpu_reference.inverse_lu(a))
    assert _resid(a, x) < max(GATE, 8 * lapack32)
    rel = np.abs(np.asarray(x, np.float64) - ref).max() / np.abs(ref).max()
    assert rel < 1e-3


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("cls", ["spd", "general", "permuted_rows",
                                 "needs_pivoting"])
def test_lu_route_matches_lapack(cls, n, rng):
    a = _batch(cls, n, rng)
    _check(a, get_inverse_algorithm("lu")(a))


@pytest.mark.parametrize("n", SIZES)
def test_cholesky_route_matches_lapack(n, rng):
    a = _batch("spd", n, rng)
    x = np.asarray(get_inverse_algorithm("cholesky")(a))
    _check(a, x)
    np.testing.assert_allclose(x, np.swapaxes(x, -1, -2), atol=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_lu_route_singular_member_non_finite(n, rng):
    # a rank-1 member (all ones) hits an exactly zero pivot: it comes back
    # non-finite, the rest of the batch is unaffected
    a = _batch("needs_pivoting", n, rng)
    a[1] = 1.0
    x = np.asarray(get_inverse_algorithm("lu")(a))
    assert not np.isfinite(x[1]).all()
    _check(a[[0, 2]], x[[0, 2]])


@pytest.mark.parametrize("n", [7, 13, 37])
@pytest.mark.parametrize("algo", ["lu", "cholesky", "newton_schulz_spd_pallas"])
def test_odd_n(algo, n, rng):
    a = _batch("spd", n, rng)
    x = get_inverse_algorithm(algo)(a)
    assert x.shape == a.shape
    _check(a, x)


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("algo", ["lu", "cholesky", "newton_schulz_spd_pallas"])
def test_engine_batch_padding(algo, batch, rng):
    # batches pad to the bucket with identity matrices and slice back
    from cuda_matrix_inversion_tpu.engine import InversionEngine

    eng = InversionEngine(algorithm=algo, batch_buckets=(8,),
                          dim_buckets=(16, 32))
    a = make_spd_batch(batch, 20, rng).astype(np.float32)
    x = eng.inverse(a)
    assert x.shape == a.shape
    assert eng.compiled_shapes == [(8, 32)]
    _check(a, x)


@pytest.mark.parametrize("n", SIZES)
def test_float64_routes_stay_float64(n, rng):
    a = make_spd_batch(2, n, rng)
    for algo in ("lu", "cholesky"):
        x = np.asarray(get_inverse_algorithm(algo)(a))
        assert x.dtype == np.float64
        assert _resid(a, x) < 1e-10
