"""Drive the library's main paths once on one GPU, each against float64.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --four-gpus  # only the batch-sharded paths, 4 GPUs

Phases (one GPU), each printing its max error, tolerance, product
precision and wall time, gated against the float64 LAPACK reference
(``ops/cpu_reference.py``) or numpy float64:

1. inversion: every device registry lane at 100×128×128 fp32 on the SPD
   fixture class, the general lanes also on the κ-capped general class;
   ``lu``/``cholesky`` at 1600×128 and 100×512; each Newton–Schulz lane at
   the edge of its stated κ domain.  Gate ‖AA⁻¹−I‖∞ < 1e-4.
2. float64 on the device: ``lu``/``cholesky`` at 100×128 (gate 1e-10) and
   ``lu_hiacc`` at κ = 500 (gate 1e-10).
3. serving: ``InversionEngine`` warmup/inverse/inverse_warm(check=True)
   and ``bucketed_inverse`` over n ∈ {8, 32, 128, 512}.
4. GP: ``GPEngine.mean_variance`` at 10 000×128, then
   ``mean_variance_warm`` on a drifted batch.
5. GP fit: ``GPEngine.fit`` for 3 Adam steps at 10 000×128, and the
   custom-VJP LML gradient on 16 systems against float64 ``jax.grad``.
6. kernel decision: the Triton Newton–Schulz kernel against the plain-XLA
   fixed schedule at 100×128 and 10 000×128 (error and median time).
7. trace: the profile summary reads GPU kernel events.

With ``--four-gpus`` only the sharded paths run, on a 1-D batch mesh of
four local GPUs, each compared with the same inputs on one GPU and with
the float64 gate.

The script refuses to run (exit 2, no result line) where JAX finds no GPU.
Its last line is ``{"ok": true, "device": {"platform", "kind", "count"}}``;
a failed phase exits 1 without it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

GATE = 1e-4
SEED = 2026

#: the product algorithms each lane's accuracy rests on (ops/precision.py)
PRECISION = {
    "lu": "XLA getrf/getri + F32 polish",
    "cholesky": "XLA potrf/trsm + F32 WtW",
    "newton_schulz": "BF16 contraction, F32 continuation+polish",
    "newton_schulz_spd": "BF16 contraction, F32 continuation+polish",
    "newton_schulz_pallas": "Triton: BF16 rounds, BF16_X3/BF16_X6 residuals",
    "newton_schulz_spd_pallas": "Triton: BF16 rounds, BF16_X3/BF16_X6 residuals",
    "newton_schulz_spd10_pallas": "Triton: BF16 rounds, BF16_X3/BF16_X6 residuals",
    "newton_schulz_pan500_pallas": "Triton: BF16_X3 rounds, BF16_X6 residuals",
    "lu_hiacc": "LU seed + exact BF16-digit residuals, F32 correction",
}
GENERAL_LANES = ("lu", "newton_schulz", "newton_schulz_pan500_pallas",
                 "lu_hiacc")


def result_line(devices) -> dict:
    d = devices[0]
    return {"ok": True, "device": {"platform": d.platform,
                                   "kind": d.device_kind,
                                   "count": len(devices)}}


class Phase:
    """Collects one phase's checks; a check that misses its gate fails
    the phase."""

    def __init__(self, name: str):
        self.name = name
        self.failures = []

    def check(self, label, err, tol, precision, seconds):
        ok = bool(err < tol)  # NaN fails
        print(f"  {label}: max_err={err:.3e} tol={tol:.0e} "
              f"precision={precision} wall_s={seconds:.3f} "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failures.append(label)


def _resid(a, x):
    from cuda_matrix_inversion_tpu.bench.reporting import identity_error_inf

    return identity_error_inf(a, x)


def _timed(fn, *args):
    import jax

    t = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return jax.device_get(out), time.perf_counter() - t


def _median_ms(fn, *args, reps=25):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts)) * 1e3


def _cond_batch(batch, n, kappa, rng, symmetric=True):
    """geomspace-spectrum batch with 2-norm condition number ``kappa``."""
    q1, _ = np.linalg.qr(rng.standard_normal((batch, n, n)))
    s = np.geomspace(1.0 / kappa, 1.0, n)
    q2 = (np.transpose(q1, (0, 2, 1)) if symmetric
          else np.linalg.qr(rng.standard_normal((batch, n, n)))[0])
    return ((q1 * s[None, None, :]) @ q2).astype(np.float32)


def _gp_problem(batch, n, rng):
    from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch

    b = make_spd_batch(batch, n, rng).astype(np.float32)
    a, c, d = (rng.random((batch, n, 1), dtype=np.float32) for _ in range(3))
    e = rng.random((batch, 1, 1), dtype=np.float32)
    return a, b, c, d, e


def _gp_ref(a, b, c, d, e):
    from cuda_matrix_inversion_tpu.ops import cpu_reference as cpu

    a, b, c, d, e = (np.asarray(x, np.float64) for x in (a, b, c, d, e))
    return (cpu.calculate_mean_solve_cpu(a, b, c, d),
            cpu.calculate_variance_solve_cpu(a, b, c, e))


# ---------------------------------------------------------------------------
# one-GPU phases
# ---------------------------------------------------------------------------

def phase_inversion(p: Phase, rng):
    import jax

    from cuda_matrix_inversion_tpu.io.fixtures import (
        make_spd_batch,
        make_square_batch,
    )
    from cuda_matrix_inversion_tpu.ops import cpu_reference
    from cuda_matrix_inversion_tpu.ops.registry import (
        get_inverse_algorithm,
        list_inverse_algorithms,
    )

    spd = make_spd_batch(100, 128, rng).astype(np.float32)
    gen = make_square_batch(100, 128, rng).astype(np.float32)
    ref = {"spd": cpu_reference.inverse_lu(spd.astype(np.float64)),
           "general": cpu_reference.inverse_lu(gen.astype(np.float64))}
    for name in list_inverse_algorithms(cpu=False):
        fn = jax.jit(get_inverse_algorithm(name))
        for cls, a in (("spd", spd), ("general", gen)):
            if cls == "general" and name not in GENERAL_LANES:
                continue
            x, sec = _timed(fn, a)
            diff = np.abs(np.asarray(x, np.float64) - ref[cls]).max()
            p.check(f"{name} {cls} 100x128 (|X-X_lapack|max={diff:.2e})",
                    _resid(a, x), GATE, PRECISION[name], sec)

    for name in ("lu", "cholesky"):
        fn = jax.jit(get_inverse_algorithm(name))
        for batch, n in ((1600, 128), (100, 512)):
            a = make_spd_batch(batch, n, rng).astype(np.float32)
            x, sec = _timed(fn, a)
            p.check(f"{name} spd {batch}x{n}", _resid(a, x), GATE,
                    PRECISION[name], sec)

    # each fixed-schedule lane at the edge of its stated κ domain
    edges = [
        ("newton_schulz_spd_pallas", "SPD kappa=30",
         _cond_batch(32, 128, 30.0, rng)),
        ("newton_schulz_pallas", "SPD kappa=30",
         _cond_batch(32, 128, 30.0, rng)),
        ("newton_schulz_pallas", "nonsymmetric kappa~100",
         _cond_batch(32, 128, 15.0, rng) + 0.015 * np.triu(
             rng.standard_normal((32, 128, 128)).astype(np.float32), 1)),
        ("newton_schulz_spd10_pallas", "SPD kappa=10",
         _cond_batch(32, 128, 10.0, rng)),
        ("newton_schulz_pan500_pallas", "nonsymmetric kappa=500",
         _cond_batch(32, 128, 500.0, rng, symmetric=False)),
        ("newton_schulz_pan500_pallas", "near-identity 3.7*I",
         np.broadcast_to(3.7 * np.eye(128, dtype=np.float32), (8, 128, 128))),
        ("newton_schulz_spd_pallas", "near-identity 3.7*I",
         np.broadcast_to(3.7 * np.eye(128, dtype=np.float32), (8, 128, 128))),
        ("newton_schulz", "nonsymmetric kappa=100",
         _cond_batch(32, 128, 100.0, rng, symmetric=False)),
        ("newton_schulz_spd", "SPD kappa=100", _cond_batch(32, 128, 100.0, rng)),
    ]
    for name, label, a in edges:
        a = np.ascontiguousarray(a, dtype=np.float32)
        x, sec = _timed(jax.jit(get_inverse_algorithm(name)), a)
        p.check(f"{name} edge {label}", _resid(a, x), GATE, PRECISION[name],
                sec)


def phase_fp64(p: Phase, rng):
    import jax

    from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
    from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

    jax.config.update("jax_enable_x64", True)
    try:
        a = make_spd_batch(100, 128, rng)
        for name in ("lu", "cholesky"):
            x, sec = _timed(jax.jit(get_inverse_algorithm(name)), a)
            assert np.asarray(x).dtype == np.float64, x.dtype
            p.check(f"{name} float64 100x128", _resid(a, x), 1e-10,
                    "float64", sec)
        h = _cond_batch(16, 128, 500.0, rng, symmetric=False).astype(np.float64)
        x, sec = _timed(jax.jit(get_inverse_algorithm("lu_hiacc")), h)
        p.check("lu_hiacc float64-in kappa=500 128", _resid(h, x), 1e-10,
                PRECISION["lu_hiacc"], sec)
    finally:
        jax.config.update("jax_enable_x64", False)


def phase_serving(p: Phase, rng):
    import cuda_matrix_inversion_tpu as cmi
    from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
    from cuda_matrix_inversion_tpu.parallel.bucketing import bucketed_inverse

    eng = cmi.InversionEngine()
    t = time.perf_counter()
    eng.warmup([(100, 128)])
    eng.warmup_warm([(100, 128)])
    print(f"  engine warmup ({eng.algorithm}, warm {eng.warm_precision}): "
          f"{time.perf_counter() - t:.3f}s", flush=True)
    a = make_spd_batch(100, 128, rng).astype(np.float32)
    t = time.perf_counter()
    x = eng.inverse(a, check=True)
    p.check(f"InversionEngine.inverse ({eng.algorithm}) 100x128",
            _resid(a, x), GATE, PRECISION[eng.algorithm],
            time.perf_counter() - t)
    noise = 1e-3 * rng.standard_normal(a.shape).astype(np.float32)
    a2 = (a * (1.0 + (noise + np.transpose(noise, (0, 2, 1))) / 2)).astype(np.float32)
    t = time.perf_counter()
    x2 = eng.inverse_warm(a2, x, check=True)
    p.check("InversionEngine.inverse_warm(check=True) drifted 100x128",
            _resid(a2, x2), GATE, PRECISION["newton_schulz_spd_pallas"],
            time.perf_counter() - t)

    sizes = [8, 32, 128, 512, 5, 100, 300, 20, 64, 128]
    mats = [make_spd_batch(1, n, rng)[0].astype(np.float32) for n in sizes]
    bucketed_inverse(mats)
    t = time.perf_counter()
    invs = bucketed_inverse(mats)
    worst = max(_resid(m[None], x[None]) for m, x in zip(mats, invs))
    p.check(f"bucketed_inverse (cholesky) n={sizes}", worst, GATE,
            PRECISION["cholesky"], time.perf_counter() - t)


def phase_gp(p: Phase, rng):
    import jax

    import cuda_matrix_inversion_tpu as cmi
    from cuda_matrix_inversion_tpu.ops import xla

    a, b, c, d, e = _gp_problem(10000, 128, rng)
    eng = cmi.GPEngine(batch_buckets=(16, 10000))
    mean, var = eng.mean_variance(a, b, c, d, e)
    t = time.perf_counter()
    mean, var = eng.mean_variance(a, b, c, d, e)
    sec = time.perf_counter() - t
    m_ref, v_ref = _gp_ref(a, b, c, d, e)
    err = max(np.abs(mean - m_ref).max(), np.abs(var - v_ref).max())
    p.check("GPEngine.mean_variance (solve) 10000x128 mean/var", err, GATE,
            "XLA potrf/trsm, F32 projections", sec)

    kinv = jax.jit(lambda b_, c_: xla.inverse_cholesky(xla.add_diagonal(b_, c_)))(
        b, c)
    noise = 1e-3 * rng.standard_normal(b.shape).astype(np.float32)
    b2 = (b * (1.0 + (noise + np.transpose(noise, (0, 2, 1))) / 2)).astype(np.float32)
    eng.mean_variance_warm(a, b2, c, d, e, np.asarray(kinv))
    t = time.perf_counter()
    mean2, var2, kinv2 = eng.mean_variance_warm(a, b2, c, d, e, np.asarray(kinv))
    sec = time.perf_counter() - t
    m_ref, v_ref = _gp_ref(a, b2, c, d, e)
    err = max(np.abs(mean2 - m_ref).max(), np.abs(var2 - v_ref).max())
    p.check("GPEngine.mean_variance_warm drifted 10000x128 mean/var", err,
            GATE, PRECISION["newton_schulz_spd_pallas"], sec)
    k2 = b2[:256] + np.eye(128, dtype=np.float32) * c[:256, :, 0][:, None, :]
    p.check("GPEngine.mean_variance_warm returned K^-1 (256 systems)",
            _resid(k2, kinv2[:256]), GATE,
            PRECISION["newton_schulz_spd_pallas"], sec)


def phase_fit(p: Phase, rng):
    import jax
    import jax.numpy as jnp

    import cuda_matrix_inversion_tpu as cmi
    from cuda_matrix_inversion_tpu.models import gp, gp_fit

    batch, n, rank = 10000, 128, 16
    w = rng.standard_normal((batch, n, rank)).astype(np.float32)
    b = (w @ np.transpose(w, (0, 2, 1)) / rank
         + 0.05 * np.eye(n, dtype=np.float32)).astype(np.float32)
    c = (rng.random((batch, n, 1)) + 0.5).astype(np.float32)
    d = rng.standard_normal((batch, n, 1)).astype(np.float32)
    eng = cmi.GPEngine(batch_buckets=(16, 10000))
    eng.fit(b, c, d, steps=3)
    t = time.perf_counter()
    res = eng.fit(b, c, d, steps=3)
    sec = time.perf_counter() - t
    finite = all(np.isfinite(x).all() for x in res)
    rising = bool(res.lml_path[-1] > res.lml_path[0])
    p.check(f"GPEngine.fit 3 steps 10000x128 (finite={finite}, "
            f"lml_path {res.lml_path[0]:.4f} -> {res.lml_path[-1]:.4f})",
            0.0 if finite and rising else np.inf, 1.0,
            "custom VJP, F32 products", sec)

    theta = jnp.asarray(0.1 * rng.standard_normal((16, 2)).astype(np.float32))
    bs, cs, ds = (jnp.asarray(x[:16]) for x in (b, c, d))
    g_vjp = jax.jit(jax.grad(lambda t_: jnp.sum(
        gp_fit._batch_lml(t_, bs, cs, ds))))
    g32, sec = _timed(g_vjp, theta)
    jax.config.update("jax_enable_x64", True)
    try:
        f64 = lambda x: jnp.asarray(np.asarray(x, np.float64))  # noqa: E731

        def lml_ref(t_):  # jax.grad through the Cholesky chain
            b_hat, c_hat = gp_fit.apply_scales(f64(bs), f64(cs), t_[:, 0],
                                               t_[:, 1])
            return jnp.sum(gp.gp_log_marginal_likelihood(b_hat, c_hat,
                                                         f64(ds)))

        g64 = np.asarray(jax.jit(jax.grad(lml_ref))(f64(theta)))
    finally:
        jax.config.update("jax_enable_x64", False)
    rel = np.abs(np.asarray(g32, np.float64) - g64).max() / max(
        1.0, np.abs(g64).max())
    p.check("LML gradient custom VJP (f32) vs float64 jax.grad, 16 systems",
            rel, 1e-3, "custom VJP, F32 products", sec)


def phase_kernel_decision(p: Phase, rng):
    import functools

    import jax

    from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
    from cuda_matrix_inversion_tpu.ops import newton_schulz as ns

    kern = jax.jit(functools.partial(ns.inverse_newton_schulz_pallas,
                                     init="spd"))
    plain = jax.jit(functools.partial(ns.inverse_newton_schulz_fixed,
                                      init="spd"))
    for batch in (100, 10000):
        a = jax.device_put(make_spd_batch(batch, 128, rng).astype(np.float32))
        host = np.asarray(a[:200])
        for label, fn in (("triton kernel", kern), ("plain XLA", plain)):
            ms = _median_ms(fn, a)
            x = np.asarray(fn(a)[:200])
            p.check(f"newton_schulz_spd {label} {batch}x128 "
                    f"median_ms={ms:.4f} (25 synced runs)",
                    _resid(host, x), GATE,
                    label + ": BF16 rounds, BF16_X3/BF16_X6 residuals",
                    ms / 1e3)


def phase_trace(p: Phase, rng):
    import jax

    from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
    from cuda_matrix_inversion_tpu.ops import xla
    from cuda_matrix_inversion_tpu.utils.profiling import profile_summary

    a = jax.device_put(make_spd_batch(100, 128, rng).astype(np.float32))
    fn = jax.jit(xla.inverse_lu)
    fn(a).block_until_ready()
    t = time.perf_counter()
    rows = profile_summary(lambda: fn(a).block_until_ready())
    for name, dur, calls, share in rows[:5]:
        print(f"    {share:6.1%} {dur:10.1f} us {calls:4d}  {name[:90]}")
    p.check(f"profile_summary device events for lu 100x128 ({len(rows)} ops)",
            0.0 if rows else np.inf, 1.0, PRECISION["lu"],
            time.perf_counter() - t)


PHASES = (
    ("1 inversion", phase_inversion),
    ("2 fp64", phase_fp64),
    ("3 serving", phase_serving),
    ("4 gp", phase_gp),
    ("5 gp fit", phase_fit),
    ("6 kernel decision", phase_kernel_decision),
    ("7 trace", phase_trace),
)


# ---------------------------------------------------------------------------
# four-GPU phase
# ---------------------------------------------------------------------------

def phase_four_gpus(p: Phase, rng):
    import jax

    from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
    from cuda_matrix_inversion_tpu.models.gp import gp_mean_variance
    from cuda_matrix_inversion_tpu.models.gp_fit import fit_gp_scales
    from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm
    from cuda_matrix_inversion_tpu.parallel import sharded
    from cuda_matrix_inversion_tpu.parallel.mesh import batch_mesh

    mesh = batch_mesh(4)
    one = jax.devices()[0]
    a = make_spd_batch(10000, 128, rng).astype(np.float32)
    for name in ("lu", "newton_schulz_spd_pallas"):
        x4, sec = _timed(lambda m: sharded.sharded_inverse(mesh, m, name), a)
        x1 = np.asarray(jax.jit(get_inverse_algorithm(name))(
            jax.device_put(a, one)))
        p.check(f"sharded_inverse {name} 10000x128 on 4 GPUs", _resid(a, x4),
                GATE, PRECISION[name], sec)
        rel = np.abs(np.asarray(x4) - x1).max() / np.abs(x1).max()
        p.check(f"sharded_inverse {name} vs one GPU (rel)", rel, 1e-5,
                PRECISION[name], sec)

    ga, gb, gc, gd, ge = _gp_problem(10000, 128, rng)
    (m4, v4), sec = _timed(
        lambda *xs: sharded.sharded_gp_mean_variance(mesh, *xs),
        ga, gb, gc, gd, ge)
    m1, v1 = jax.jit(gp_mean_variance)(*(jax.device_put(x, one)
                                          for x in (ga, gb, gc, gd, ge)))
    m_ref, v_ref = _gp_ref(ga, gb, gc, gd, ge)
    p.check("sharded_gp_mean_variance 10000x128 vs float64",
            max(np.abs(m4 - m_ref).max(), np.abs(v4 - v_ref).max()), GATE,
            "XLA potrf/trsm, F32 projections", sec)
    p.check("sharded_gp_mean_variance vs one GPU",
            max(np.abs(m4 - np.asarray(m1)).max(),
                np.abs(v4 - np.asarray(v1)).max()), 1e-5,
            "XLA potrf/trsm, F32 projections", sec)

    batch, n, rank = 10000, 128, 16
    w = rng.standard_normal((batch, n, rank)).astype(np.float32)
    fb = (w @ np.transpose(w, (0, 2, 1)) / rank
          + 0.05 * np.eye(n, dtype=np.float32)).astype(np.float32)
    fc = (rng.random((batch, n, 1)) + 0.5).astype(np.float32)
    fd = rng.standard_normal((batch, n, 1)).astype(np.float32)
    r4, sec = _timed(lambda *xs: sharded.sharded_fit_gp_scales(
        mesh, *xs, steps=3), fb, fc, fd)
    r1 = fit_gp_scales(*(jax.device_put(x, one) for x in (fb, fc, fd)),
                       steps=3)
    diff = max(np.abs(np.asarray(x4) - np.asarray(x1)).max()
               for x4, x1 in zip(r4[:2], r1[:2]))
    finite = all(np.isfinite(np.asarray(x)).all() for x in r4)
    p.check(f"sharded_fit_gp_scales 3 steps 10000x128 theta vs one GPU "
            f"(finite={finite})", diff if finite else np.inf, 1e-4,
            "custom VJP, F32 products", sec)


# ---------------------------------------------------------------------------

def _nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the batch-sharded paths on 4 local GPUs")
    args = ap.parse_args(argv)

    print(_nvidia_smi(), flush=True)
    import jax

    devices = jax.devices()
    print(devices, flush=True)
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX platform is "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 2
    if args.four_gpus and len(devices) < 4:
        print(f"chip_smoke: --four-gpus needs 4 GPUs, have {len(devices)}",
              file=sys.stderr)
        return 2

    from cuda_matrix_inversion_tpu.utils.cache import enable_compilation_cache

    print(f"compile cache: {enable_compilation_cache()}", flush=True)
    phases = ((("four gpus", phase_four_gpus),) if args.four_gpus
              else PHASES)
    failed = []
    rng = np.random.default_rng(SEED)
    for name, run in phases:
        p = Phase(name)
        print(f"phase {name}", flush=True)
        t = time.perf_counter()
        try:
            run(p, rng)
        except Exception:  # a crashed phase is a failed phase
            traceback.print_exc()
            p.failures.append("exception")
        print(f"phase {name}: {'FAIL ' + str(p.failures) if p.failures else 'ok'}"
              f" ({time.perf_counter() - t:.1f}s)", flush=True)
        if p.failures:
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps(result_line(devices)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
