"""GP mean/variance pipeline benchmark CLI.

Reference counterpart: ``src/gauss_bench.cu:577-702`` — argv contract
``TEST_FOLDER NUM_REPS NUM_DUPLICATES [-csv]``, loads the 7 GP fixture
files, replicates, times CPU then device mean+variance over reps, and
reports average |err| per matrix against the MATLAB ``means.mats`` /
``variances.mats``.

Timer names match the reference CSVs (``means_cpu``, ``variances_cpu``,
``means_gpu``, ``variances_gpu`` — ``results/gauss-bench-errors.txt``) so
downstream tooling keeps parsing; the ``_gpu`` rows run on the device.

``--stages`` reproduces the ``-DDETAILED_LOGGING`` stage split
(``calculate_mean_gpu_{mem_htod,add,inv,mul,dot,mem_dtoh}`` lines,
``results/gauss-bench.txt:21-27``) by timing each pipeline stage with a
sync between stages — the un-fused configuration.  The default path is
the fused single-dispatch pipeline (one jit region, no host round trips).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from cuda_matrix_inversion_tpu.bench.reporting import (
    BenchReporter,
    l1_total,
    print_device_info,
)
from cuda_matrix_inversion_tpu.io.mats import read_test_folder
from cuda_matrix_inversion_tpu.io.replicate import replicate_matrices
from cuda_matrix_inversion_tpu.utils.timer import Timer


def _replicate_all(data: dict, dups: int) -> dict:
    return {k: replicate_matrices(v, dups) for k, v in data.items()}


def run_bench(
    folder: str,
    num_reps: int,
    num_duplicates: int,
    csv: bool = False,
    method: str = "solve",
    stages: bool = False,
    skip_cpu: bool = False,
    dtype=np.float32,
    transfers: bool = False,
    stream=None,
    cpu_oracle: str = "auto",
    fit: bool = False,
) -> BenchReporter:
    import jax

    from cuda_matrix_inversion_tpu.models import gp
    from cuda_matrix_inversion_tpu.ops import cpu_reference as cpu

    data = _replicate_all(read_test_folder(folder, kind="gaussian", dtype=dtype), num_duplicates)
    a, b, c, d, e = data["a"], data["b"], data["c"], data["d"], data["e"]
    means_ref, vars_ref = data["means"], data["variances"]
    num_matrices, n = b.shape[0], b.shape[1]

    stream = stream or sys.stdout
    rep = BenchReporter(num_matrices, n, num_reps, csv=csv, stream=stream)
    if not csv:
        print_device_info(stream)

    # --- CPU phase (ref calcluateMean[Solve]CPU / ...Variance..., timed) ---
    if not skip_cpu:
        use_native = False
        if cpu_oracle in ("auto", "native"):
            from cuda_matrix_inversion_tpu.native import oracle as native_oracle

            use_native = native_oracle.available()
            if cpu_oracle == "native" and not use_native:
                raise RuntimeError("native oracle requested but not built "
                                   "(python -m cuda_matrix_inversion_tpu.native.build)")
        if use_native:
            # the C++/LAPACK/OpenMP gauss_cpu.c equivalent; want= selects
            # the reference's distinct single-output workloads so each
            # timer row measures factorize + ONE solve, like the original
            solve = method == "solve"
            mean_fn = lambda a_, b_, c_, d_: native_oracle.gp_mean_variance(  # noqa: E731
                a_, b_, c_, d_, np.zeros(b_.shape[0], dtype=b_.dtype),
                solve=solve, want="mean")[0].reshape(-1, 1, 1)
            var_fn = lambda a_, b_, c_, e_: native_oracle.gp_mean_variance(  # noqa: E731
                a_, b_, c_, a_, e_, solve=solve,
                want="variance")[1].reshape(-1, 1, 1)
        else:
            mean_fn = cpu.calculate_mean_solve_cpu if method == "solve" else cpu.calculate_mean_cpu
            var_fn = cpu.calculate_variance_solve_cpu if method == "solve" else cpu.calculate_variance_cpu
        em = rep.entry("means_cpu")
        ev = rep.entry("variances_cpu")
        means = variances = None
        for _ in range(num_reps):
            em.timer.start()
            means = mean_fn(a, b, c, d)
            em.timer.stop()
            ev.timer.start()
            variances = var_fn(a, b, c, e)
            ev.timer.stop()
        em.total_error = l1_total(means, means_ref)
        ev.total_error = l1_total(variances, vars_ref)
        rep.report("means_cpu")
        rep.report("variances_cpu")

    # --- device phase: fused jit pipelines ---
    mean_j = lambda *xs: gp.gp_mean(*xs, method=method)  # noqa: E731
    var_j = lambda *xs: gp.gp_variance(*xs, method=method)  # noqa: E731

    put = jax.device_put
    a_d, b_d, c_d, d_d, e_d = put(a), put(b), put(c), put(d), put(e)
    # warmup/compile outside the timers
    mean_j(a_d, b_d, c_d, d_d).block_until_ready()
    var_j(a_d, b_d, c_d, e_d).block_until_ready()

    em = rep.entry("means_gpu")
    ev = rep.entry("variances_gpu")
    means = variances = None
    if transfers:
        for _ in range(num_reps):
            em.timer.start()
            means = np.asarray(jax.device_get(mean_j(put(a), put(b), put(c), put(d))))
            em.timer.stop()
            ev.timer.start()
            variances = np.asarray(jax.device_get(var_j(put(a), put(b), put(c), put(e))))
            ev.timer.stop()
    else:
        # device-resident: dependency-chained slope timing (bench/timing.py);
        # perturb operand 1 (B) to defeat loop hoisting. One call compiles
        # the timing loops once and yields num_reps samples.
        from cuda_matrix_inversion_tpu.bench.timing import looped_pipeline_samples

        for sec in looped_pipeline_samples(mean_j, (a, b, c, d), iters=4,
                                           trials=num_reps, perturb=1):
            em.timer.stats.add(max(sec, 0.0))
            em.timer.last_seconds = max(sec, 0.0)
        for sec in looped_pipeline_samples(var_j, (a, b, c, e), iters=4,
                                           trials=num_reps, perturb=1):
            ev.timer.stats.add(max(sec, 0.0))
            ev.timer.last_seconds = max(sec, 0.0)
        means = mean_j(a_d, b_d, c_d, d_d)
        variances = var_j(a_d, b_d, c_d, e_d)
    means = np.asarray(jax.device_get(means))
    variances = np.asarray(jax.device_get(variances))
    em.total_error = l1_total(means, means_ref)
    ev.total_error = l1_total(variances, vars_ref)
    rep.report("means_gpu")
    rep.report("variances_gpu")

    if stages:
        _run_stage_split(rep, a, b, c, d, num_matrices, n, stream)
    if fit:
        _run_fit_rows(rep, b, c, d, num_reps)
    return rep


def _run_fit_rows(rep, b, c, d, num_reps):
    """Hyper-parameter-fit step rows (beyond-parity; ``--fit``).

    Times one ``value_and_grad`` step of the mean-LML loss
    (``models/gp_fit.py``) for both LML gradients — ``fit_step_xla``
    (autodiff through the Cholesky chain) and ``fit_step_vjp`` (the
    analytic custom VJP).  The error column carries the |grad diff|
    between the two backends (the XLA chain is the oracle) — reported,
    like every row, as the per-matrix average (the reporter divides the
    stored total by numMatrices) — so a custom-VJP regression shows up
    exactly like an accuracy regression in every other row.
    """
    import jax
    import jax.numpy as jnp

    from cuda_matrix_inversion_tpu.bench.timing import looped_pipeline_samples
    from cuda_matrix_inversion_tpu.models import gp, gp_fit

    bb, cc, dd = (jnp.asarray(x) for x in (b, c, d))
    theta = jnp.zeros((b.shape[0], 2), bb.dtype)
    lml = {"xla": gp.gp_log_marginal_likelihood,
           "vjp": gp.gp_log_marginal_likelihood_vjp}
    grads = {}
    for method in ("xla", "vjp"):
        loss = lambda t, f=lml[method]: -jnp.mean(  # noqa: E731
            f(*gp_fit.apply_scales(bb, cc, t[:, 0], t[:, 1]), dd))
        vg = jax.value_and_grad(loss)
        entry = rep.entry(f"fit_step_{method}")
        for sec in looped_pipeline_samples(vg, (theta,), iters=8,
                                           trials=num_reps):
            entry.timer.stats.add(max(sec, 0.0))
            entry.timer.last_seconds = max(sec, 0.0)
        grads[method] = np.asarray(jax.device_get(vg(theta)[1]))
    gdiff = float(np.abs(grads["vjp"] - grads["xla"]).sum())
    rep.entries["fit_step_xla"].total_error = 0.0
    rep.entries["fit_step_vjp"].total_error = gdiff
    rep.report("fit_step_xla")
    rep.report("fit_step_vjp")


def _run_stage_split(rep, a, b, c, d, num_matrices, n, stream):
    """Un-fused per-stage timing, mirroring the DETAILED_LOGGING build
    (``src/gauss_bench.cu:150-256``).  Emits ``name,numMatrices,n,ms,ns``
    lines (``include/timer.h:8-9``)."""
    import jax
    import jax.numpy as jnp

    from cuda_matrix_inversion_tpu.ops import xla as ops

    add_j = jax.jit(ops.add_diagonal)
    inv_j = jax.jit(ops.inverse_lu)
    mul_j = jax.jit(ops.matmul)
    dot_j = jax.jit(lambda x, y: jnp.matmul(jnp.swapaxes(x, -1, -2), y))

    # warmup every stage's compile (incl. dot) outside the timers
    kdev = add_j(jax.device_put(b), jax.device_put(c))
    minv = inv_j(kdev)
    x0 = mul_j(minv, jax.device_put(d))
    dot_j(jax.device_put(a), x0).block_until_ready()

    t = Timer("calculate_mean_gpu_mem_htod")
    t.start()
    b_dev = jax.device_put(b)
    c_dev = jax.device_put(c)
    d_dev = jax.device_put(d)
    t.stop(b_dev, c_dev, d_dev)
    t.log(num_matrices, n, stream)

    t = Timer("calculate_mean_gpu_add")
    t.start()
    k = add_j(b_dev, c_dev)
    t.stop(k)
    t.log(num_matrices, n, stream)

    t = Timer("calculate_mean_gpu_inv")
    t.start()
    k_inv = inv_j(k)
    t.stop(k_inv)
    t.log(num_matrices, n, stream)

    t = Timer("calculate_mean_gpu_mul")
    t.start()
    x = mul_j(k_inv, d_dev)
    t.stop(x)
    t.log(num_matrices, n, stream)

    a_dev = jax.device_put(a)
    t = Timer("calculate_mean_gpu_dot")
    t.start()
    m = dot_j(a_dev, x)
    t.stop(m)
    t.log(num_matrices, n, stream)

    t = Timer("calculate_mean_gpu_mem_dtoh")
    t.start()
    np.asarray(jax.device_get(m))
    t.stop()
    t.log(num_matrices, n, stream)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gauss_bench",
        description="GP mean/variance pipeline benchmark (JAX rebuild of src/gauss_bench.cu)",
    )
    p.add_argument("test_folder")
    p.add_argument("num_reps", type=int)
    p.add_argument("num_duplicates", type=int)
    p.add_argument("-csv", action="store_true", dest="csv")
    p.add_argument("--method", default="solve",
                   choices=["solve", "inverse", "lu", "newton_schulz"],
                   help="solve = the reference's -DGAUSS_SOLVE build; lu = its "
                        "GPU pipeline")
    p.add_argument("--stages", action="store_true",
                   help="emit the DETAILED_LOGGING per-stage split (un-fused)")
    p.add_argument("--skip-cpu", action="store_true")
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--transfers", action="store_true",
                   help="time H2D+pipeline+D2H per rep (reference parity) instead of device-resident")
    p.add_argument("--fit", action="store_true",
                   help="also time one hyper-parameter-fit value_and_grad "
                        "step per LML gradient (fit_step_xla / "
                        "fit_step_vjp rows; models/gp_fit.py)")
    p.add_argument("--cpu-oracle", default="auto",
                   choices=["auto", "scipy", "native"],
                   help="CPU rows: native = C++/LAPACK/OpenMP gauss_cpu.c "
                        "equivalent; auto = native when built, else scipy")
    from cuda_matrix_inversion_tpu.utils.backend import (
        backend_argument,
        pin_backend,
    )

    backend_argument(p)
    args = p.parse_args(argv)

    from cuda_matrix_inversion_tpu.utils.cache import enable_compilation_cache

    pin_backend(args.backend)
    enable_compilation_cache()

    if args.dtype == "float64":
        from cuda_matrix_inversion_tpu.types import enable_x64

        enable_x64()
    from cuda_matrix_inversion_tpu.utils.errors import EnsureError

    try:
        run_bench(
            args.test_folder,
            args.num_reps,
            args.num_duplicates,
            csv=args.csv,
            method=args.method,
            stages=args.stages,
            skip_cpu=args.skip_cpu,
            dtype=np.dtype(args.dtype),
            transfers=args.transfers,
            cpu_oracle=args.cpu_oracle,
            fit=args.fit,
        )
    except EnsureError as e:
        print(f"gauss_bench: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
