"""Test harness config: run JAX on 8 virtual CPU devices.

The real benchmark path runs on the GPU (``chip_smoke.py``, ``bench.py``);
tests validate numerics and the multi-device sharding story on a virtual
CPU mesh, with the Pallas kernels in the Pallas interpreter — asked for
explicitly here (``CMI_PALLAS_INTERPRET``), never inferred from the backend.
"""

import os

# Must be set before jax is imported anywhere. Force CPU even if the shell
# has JAX_PLATFORMS pointed at real hardware — tests are numerics tests.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["CMI_PALLAS_INTERPRET"] = "1"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402

# Belt and braces: pin the platform through the config API as well.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # fp64 sweep support (tests always on CPU)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    The full suite compiles many hundreds of CPU executables in one
    process; at that volume jaxlib's compiler segfaulted inside
    backend_compile_and_load near the END of the suite (reproduced solo
    2026-08-19, exit 139 in test_xla_ops after ~280 green tests; the same
    tests pass in isolation).  Dropping executable caches at module
    boundaries keeps the live-compilation footprint bounded with no
    cross-module cache value — modules compile disjoint shapes."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def spd_batch(rng):
    """Small SPD batch built the same way as the reference fixtures
    (generate_inverse_matrices.m:8-18)."""
    from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch

    return make_spd_batch(12, 16, rng).astype(np.float32)


@pytest.fixture(scope="session")
def fixture_root(tmp_path_factory):
    """Generated .mats fixture tree (small dims to keep tests fast)."""
    from cuda_matrix_inversion_tpu.io import fixtures

    root = tmp_path_factory.mktemp("mats_fixtures")
    fixtures.generate_all(str(root), dims=(8, 16), num=20, seed=7)
    return str(root)
