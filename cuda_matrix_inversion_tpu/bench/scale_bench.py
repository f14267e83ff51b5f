"""Scale-out benchmark: large batches sharded over the device mesh.

BASELINE.json config 5: "fp32/fp64 sweep, 10k-matrix batch of 128×128"
sharded over the devices present.  The workload is collective-free
(SURVEY §5: batch-parallel inversion needs no cross-matrix reduction), so
scaling is linear in devices; this CLI runs on however many devices the
backend exposes.  fp64 runs natively on the device (``jax_enable_x64``);
``--force-cpu`` pins a CPU mesh of ``--devices`` virtual devices.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def run(num: int, n: int, dtype: str, algorithm: str, n_devices: int | None,
        iters: int = 4, trials: int = 3, force_cpu: bool = False) -> dict:
    import os

    import jax

    if force_cpu:
        # XLA_FLAGS is parsed exactly once per process — set it BEFORE the
        # first backend touch (no jax.devices() yet!).
        if n_devices:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={n_devices}").strip()
        jax.config.update("jax_platforms", "cpu")

    if dtype == "float64":
        from cuda_matrix_inversion_tpu.types import enable_x64

        enable_x64()

    from cuda_matrix_inversion_tpu.bench.timing import chained_op_seconds
    from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
    from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm
    from cuda_matrix_inversion_tpu.parallel.mesh import (
        batch_mesh,
        batch_sharding,
        pad_to_multiple,
    )

    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    mesh = batch_mesh(n_devices)

    rng = np.random.default_rng(7)
    a = make_spd_batch(num, n, rng).astype(dtype)
    a_pad, orig = pad_to_multiple(a, n_devices)
    sharding = batch_sharding(mesh, 3)
    a_dev = jax.device_put(a_pad, sharding)

    fn = get_inverse_algorithm(algorithm)
    # clamp: slope timing can go slightly negative under host jitter
    sec = max(chained_op_seconds(fn, a_dev, iters=iters, trials=trials), 1e-9)

    # accuracy gate on a host-side sample
    out = jax.jit(fn)(a_dev)
    sample = np.asarray(jax.device_get(out[:32]), dtype=np.float64)
    err = np.abs(a_pad[:32].astype(np.float64) @ sample - np.eye(n)).sum(-1).max()

    return {
        "metric": f"sharded_inversions_per_sec_{num}x{n}x{n}_{dtype}",
        "value": round(orig / sec, 1),
        "unit": "inversions/s",
        "detail": {
            "algorithm": algorithm,
            "devices": n_devices,
            "batch_ms": round(sec * 1e3, 3),
            "max_identity_err_inf": float(f"{err:.3e}"),
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="sharded large-batch inversion benchmark")
    p.add_argument("--num", type=int, default=10000)
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--algorithm", default="lu")
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--force-cpu", action="store_true")
    args = p.parse_args(argv)

    from cuda_matrix_inversion_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    # run() owns the backend pin (it must set XLA_FLAGS for virtual CPU
    # devices BEFORE the first backend touch, so no jax.devices() here)
    print(json.dumps(run(args.num, args.n, args.dtype, args.algorithm,
                         args.devices, force_cpu=args.force_cpu)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
