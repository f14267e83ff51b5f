"""Run the five BASELINE.json benchmark configs end-to-end.

Emits one JSON object per config (and writes them all to --out).  The
configs, verbatim from BASELINE.json:

1. batched Gauss-Jordan inverse, tests/inverse_100_8x8 (CPU reference
   path; the device runs its batched LU and is checked against it)
2. batched Cholesky inverse on SPD batch (tests/spd_100_64_64.mats)
3. gauss_bench GP mean pipeline A*(B+C)^{-1}*D on gaussian_100_128x128
4. mixed-dimension size-bucketed queues (8/32/128/512) in one fused dispatch
5. fp32/fp64 sweep, 10k-matrix batch of 128x128 sharded across the
   devices present (scale_bench; fp64 runs natively on the device)
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np


def _err_inf(a, inv):
    n = a.shape[-1]
    return float(np.abs(a.astype(np.float64) @ inv.astype(np.float64)
                        - np.eye(n)).sum(-1).max())


def config1_gauss_jordan(fixtures: str) -> dict:
    import jax

    from cuda_matrix_inversion_tpu.bench.timing import (
        chained_op_seconds,
        enqueue_slope_seconds,
    )
    from cuda_matrix_inversion_tpu.io.mats import read_test_folder
    from cuda_matrix_inversion_tpu.ops import cpu_reference
    from cuda_matrix_inversion_tpu.ops.xla import inverse_lu

    data = read_test_folder(os.path.join(fixtures, "inverse_100_8x8"))
    a = data["a"]
    inv = np.asarray(jax.device_get(jax.jit(inverse_lu)(jax.device_put(a))))
    oracle = cpu_reference.inverse_gauss_jordan(a)  # the CPU reference path
    # tiny config: long chains so the slope rises above host jitter; if
    # the median still clamps to 0, fall back to the enqueue-slope method
    sec = max(chained_op_seconds(inverse_lu, a, iters=64, trials=5), 0.0)
    if sec <= 0.0:
        sec = max(enqueue_slope_seconds(
            inverse_lu, [a], n1=32, n2=128, trials=3), 0.0)
    return {
        "config": "lu_inverse_vs_gauss_jordan_oracle_100x8x8",
        "batch_ms": round(sec * 1e3, 4),
        "max_identity_err_inf": float(f"{_err_inf(a, inv):.3e}"),
        "max_delta_vs_cpu_oracle": float(f"{np.abs(inv - oracle).max():.3e}"),
        "gate_1e-4": bool(_err_inf(a, inv) < 1e-4),
    }


def config2_cholesky_spd(fixtures: str) -> dict:
    import jax

    from cuda_matrix_inversion_tpu.bench.timing import chained_op_seconds
    from cuda_matrix_inversion_tpu.io.mats import read_mats
    from cuda_matrix_inversion_tpu.ops.xla import inverse_cholesky

    a = read_mats(os.path.join(fixtures, "spd_100_64_64.mats"))
    inv = np.asarray(jax.device_get(
        jax.jit(inverse_cholesky)(jax.device_put(a))))
    sec = max(chained_op_seconds(inverse_cholesky, a, iters=16, trials=3), 0.0)
    return {
        "config": "cholesky_inverse_spd_100x64x64",
        "batch_ms": round(sec * 1e3, 4),
        "max_identity_err_inf": float(f"{_err_inf(a, inv):.3e}"),
        "gate_1e-4": bool(_err_inf(a, inv) < 1e-4),
    }


def config3_gp_mean(fixtures: str) -> dict:
    import jax

    from cuda_matrix_inversion_tpu.bench.timing import looped_pipeline_samples
    from cuda_matrix_inversion_tpu.io.mats import read_test_folder
    from cuda_matrix_inversion_tpu.models.gp import gp_mean_variance

    g = read_test_folder(os.path.join(fixtures, "gaussian_100_128x128"))
    fn = lambda *xs: gp_mean_variance(*xs, method="solve")  # noqa: E731
    mean, var = (np.asarray(jax.device_get(x)) for x in
                 fn(*(jax.device_put(g[k]) for k in "abcde")))
    secs = looped_pipeline_samples(fn, [g[k] for k in "abcde"], iters=8,
                                   trials=3, perturb=1)
    return {
        "config": "gp_mean_pipeline_gaussian_100x128x128_one_jit_region",
        "batch_ms": round(max(float(np.median(secs)), 0.0) * 1e3, 4),
        "max_mean_err": float(f"{np.abs(mean - g['means']).max():.3e}"),
        "max_var_err": float(f"{np.abs(var - g['variances']).max():.3e}"),
        "gate_1e-4": bool(np.abs(mean - g["means"]).max() < 1e-4),
    }


def config4_mixed_dim() -> dict:
    import time

    from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
    from cuda_matrix_inversion_tpu.parallel.bucketing import bucketed_inverse

    rng = np.random.default_rng(11)
    sizes = [5, 8, 20, 32, 100, 128, 300, 512, 7, 64]
    mats = [make_spd_batch(1, n, rng)[0].astype(np.float32) for n in sizes]
    bucketed_inverse(mats, algorithm="cholesky")  # warm/compile
    t0 = time.perf_counter()
    invs = bucketed_inverse(mats, algorithm="cholesky")
    wall_ms = (time.perf_counter() - t0) * 1e3
    worst = max(_err_inf(m[None], i[None]) for m, i in zip(mats, invs))
    return {
        "config": "mixed_dim_buckets_8_32_128_512_one_dispatch",
        "sizes": sizes,
        "wall_ms_incl_transfers": round(wall_ms, 2),
        "max_identity_err_inf": float(f"{worst:.3e}"),
        "gate_1e-4": bool(worst < 1e-4),
    }


def config5_scale(fp64: bool) -> dict:
    from cuda_matrix_inversion_tpu.bench import scale_bench

    # spd variant: the 10k batch is the SPD fixture class (BASELINE.json
    # north star), where the SPD start halves the pan start's rounds
    out = scale_bench.run(10000, 128, "float32", "newton_schulz_spd_pallas", None)
    result = {"config": "scale_10k_128x128", "fp32": out}
    if fp64:
        result["fp64"] = scale_bench.run(10000, 128, "float64", "lu", None)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="run the BASELINE.json configs")
    p.add_argument("--fixtures", default=None,
                   help="fixture root (default: generate into a temp dir)")
    p.add_argument("--out", default=None,
                   help="also write the results to this JSON file")
    p.add_argument("--skip", nargs="*", default=[], type=int)
    args = p.parse_args(argv)

    from cuda_matrix_inversion_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    fixtures = args.fixtures
    if fixtures is None:
        fixtures = os.path.join(tempfile.gettempdir(), "cmi_fixtures")
    need = ["inverse_100_8x8", "gaussian_100_128x128", "spd_100_64_64.mats"]
    if not all(os.path.exists(os.path.join(fixtures, n)) for n in need):
        from cuda_matrix_inversion_tpu.io.fixtures import generate_all

        generate_all(fixtures)

    runners = {
        1: lambda: config1_gauss_jordan(fixtures),
        2: lambda: config2_cholesky_spd(fixtures),
        3: lambda: config3_gp_mean(fixtures),
        4: config4_mixed_dim,
        5: lambda: config5_scale(fp64=True),
    }
    results = []
    for idx, run in runners.items():
        if idx in args.skip:
            continue
        res = run()
        print(json.dumps(res))
        results.append(res)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        merged = {}
        if os.path.exists(args.out):  # merge with prior runs (by config key)
            try:
                with open(args.out) as f:
                    merged = {r["config"]: r for r in json.load(f)}
            except Exception:
                merged = {}
        for r in results:
            merged[r["config"]] = r
        with open(args.out, "w") as f:
            json.dump(list(merged.values()), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
