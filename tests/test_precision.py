"""Pinned product algorithms (``ops/precision.py``): every product a κ
domain or an accuracy gate rests on names its algorithm, so it means the
same on every backend (``Precision.DEFAULT``/``HIGH`` do not)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from cuda_matrix_inversion_tpu.ops import newton_schulz as ns
from cuda_matrix_inversion_tpu.ops import precision

NAMED = (precision.F32, precision.BF16, precision.BF16_X3, precision.BF16_X6)


def _dot_precisions(fn, *args):
    """Every dot_general's precision in ``fn``'s jaxpr, sub-jaxprs included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


@pytest.mark.parametrize("alg", NAMED, ids=lambda a: a.name)
def test_matmul_pins_the_algorithm(alg):
    x = jnp.ones((2, 16, 16), jnp.float32)
    assert _dot_precisions(lambda a: precision.matmul(a, a, alg), x) == [alg]
    assert precision.matmul(x, x, alg).dtype == jnp.float32


def test_matmul_float64_runs_native_f64():
    x = jnp.ones((2, 8, 8), jnp.float64)
    (prec,) = _dot_precisions(lambda a: precision.matmul(a, a), x)
    assert prec == (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
    assert precision.matmul(x, x).dtype == jnp.float64


@pytest.mark.parametrize("lane", [
    {}, {"init": "spd"}, {"precision": "split3"},
    {"init": "spd", "polish_highest": False}])
def test_fixed_schedule_names_every_product(lane):
    a = jnp.ones((2, 16, 16), jnp.float32)
    precs = _dot_precisions(
        lambda x: ns.inverse_newton_schulz_fixed(x, **lane), a)
    assert precs and all(p in NAMED for p in precs), precs
    # the residual deciding the gate is fp32-class unless the lane says not
    fp32_class = precision.BF16_X6 in precs
    assert fp32_class == lane.get("polish_highest", True)


def test_adaptive_schedule_names_every_product():
    a = jnp.asarray(np.eye(16, dtype=np.float32)[None].repeat(2, 0))
    precs = _dot_precisions(ns.inverse_newton_schulz, a)
    assert set(precs) == {precision.BF16, precision.F32}


@pytest.mark.parametrize("route", ["lu", "cholesky"])
def test_xla_routes_polish_in_f32(route):
    from cuda_matrix_inversion_tpu.ops import xla

    a = jnp.ones((2, 8, 8), jnp.float32) + 8 * jnp.eye(8, dtype=jnp.float32)
    fn = {"lu": xla.inverse_lu, "cholesky": xla.inverse_cholesky}[route]
    precs = _dot_precisions(fn, a)
    # the repo's own products are F32; jnp.linalg's internals pin HIGHEST
    highest = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
    assert precision.F32 in precs
    assert set(precs) <= {precision.F32, highest}
