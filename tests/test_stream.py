"""Tests for the streaming prefetch loader (io/stream.py) and fp64 routing."""

import os

import numpy as np
import pytest

from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
from cuda_matrix_inversion_tpu.io.mats import write_mats
from cuda_matrix_inversion_tpu.io.stream import DeviceBatchStream, stream_inverse


def test_stream_from_arrays(rng):
    arrays = [rng.standard_normal((5, 4, 4)).astype(np.float32) for _ in range(3)]
    got = [np.asarray(b) for b in DeviceBatchStream(arrays)]
    assert len(got) == 3
    np.testing.assert_allclose(got[1], arrays[1], atol=1e-7)


def test_stream_rebatching(rng):
    arrays = [rng.standard_normal((7, 3, 3)).astype(np.float32) for _ in range(4)]
    batches = [np.asarray(b) for b in DeviceBatchStream(arrays, batch_size=10)]
    sizes = [b.shape[0] for b in batches]
    assert sizes == [10, 10, 8]  # 28 total
    np.testing.assert_allclose(
        np.concatenate(batches), np.concatenate(arrays), atol=1e-7)


def test_stream_from_mats_files(tmp_path, rng):
    paths = []
    for i in range(3):
        arr = make_spd_batch(6, 8, rng)
        p = str(tmp_path / f"part{i}.mats")
        write_mats(p, arr)
        paths.append(p)
    batches = [np.asarray(b) for b in DeviceBatchStream(paths, batch_size=6)]
    assert len(batches) == 3 and batches[0].shape == (6, 8, 8)


def test_stream_propagates_errors(tmp_path):
    bad = str(tmp_path / "missing.mats")
    with pytest.raises(Exception):
        list(DeviceBatchStream([bad]))


def test_stream_transform_and_device_residency(rng):
    import jax

    arrays = [rng.standard_normal((4, 4, 4)).astype(np.float32)]
    out = list(DeviceBatchStream(arrays, transform=lambda x: x * 2))
    assert isinstance(out[0], jax.Array)  # already device-resident
    np.testing.assert_allclose(np.asarray(out[0]), arrays[0] * 2, atol=1e-6)


def test_stream_inverse_end_to_end(tmp_path, rng):
    paths = []
    ref = []
    for i in range(2):
        arr = make_spd_batch(5, 16, rng)
        ref.append(arr)
        p = str(tmp_path / f"s{i}.mats")
        write_mats(p, arr)
        paths.append(p)
    outs = list(stream_inverse(paths, algorithm="lu", batch_size=5))
    allref = np.concatenate(ref).astype(np.float64)
    allout = np.concatenate(outs).astype(np.float64)
    err = np.abs(allref @ allout - np.eye(16)).max()
    assert err < 1e-4


# ---- fp64 routing through the device wrappers ----

def test_pallas_wrappers_keep_fp64_exact(rng):
    import jax.numpy as jnp

    from cuda_matrix_inversion_tpu.ops import xla
    from cuda_matrix_inversion_tpu.ops.newton_schulz import (
        inverse_newton_schulz,
        inverse_newton_schulz_pallas,
    )

    a = make_spd_batch(4, 16, rng)  # float64
    for fn in (xla.inverse_cholesky, inverse_newton_schulz_pallas,
               inverse_newton_schulz):
        inv = np.asarray(fn(jnp.asarray(a)))
        assert inv.dtype == np.float64
        err = np.abs(a @ inv - np.eye(16)).max()
        assert err < 1e-12, f"{fn.__name__}: fp64 precision lost (err={err})"


def test_fused_gp_fp64(rng):
    import jax.numpy as jnp

    from cuda_matrix_inversion_tpu.models.gp import (
        gp_mean_variance as gp_mean_variance_fused,
    )

    n, batch = 16, 4
    b = make_spd_batch(batch, n, rng)
    a = rng.random((batch, n, 1))
    c = rng.random((batch, n, 1))
    d = rng.random((batch, n, 1))
    e = rng.random((batch, 1, 1))
    mean, var = gp_mean_variance_fused(*(jnp.asarray(x) for x in (a, b, c, d, e)))
    k = b + np.eye(n) * c[:, :, 0][:, None, :]
    kinv = np.linalg.inv(k)
    mref = np.transpose(a, (0, 2, 1)) @ (kinv @ d)
    assert np.abs(np.asarray(mean) - mref).max() < 1e-12


def test_stream_consumer_abandonment_releases_producer(tmp_path, rng):
    import threading
    import time

    arrays = [rng.standard_normal((2, 3, 3)).astype(np.float32) for _ in range(50)]
    before = threading.active_count()
    for batch in DeviceBatchStream(arrays, prefetch=1):
        break  # abandon immediately
    # producer must notice and exit (daemon threads drain within ~200ms)
    for _ in range(50):
        if threading.active_count() <= before:
            break
        time.sleep(0.05)
    assert threading.active_count() <= before
