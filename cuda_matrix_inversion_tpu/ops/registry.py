"""Algorithm registry for batched inversion.

The reference exposes six inversion algorithms side by side in its bench
(``src/inverse_bench.c:84-89``: lu_blas_cpu, lu_blas_omp_cpu, chol_gpu,
chol_mm2_gpu, gauss_batched_gpu, lu_cuda_batched_gpu).  This registry is
the single place those capability names map to implementations, so the
CLIs, tests, and bench all dispatch the same way.

Device algorithms take and return ``(batch, n, n)`` jnp arrays and are
jit-composable.  CPU algorithms take/return ndarrays (the oracle).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

_DEVICE_ALGORITHMS: Dict[str, Callable] = {}
_CPU_ALGORITHMS: Dict[str, Callable] = {}
# Algorithms whose device path contains a Pallas kernel.  The GSPMD
# partitioner cannot split a Pallas custom call across a multi-device mesh
# (it replicates or errors), so the sharded wrappers route these through
# shard_map, which runs the single-device kernel verbatim on each shard.
_PALLAS_ALGORITHMS: set = set()


def register_inverse(name: str, fn: Callable, cpu: bool = False,
                     pallas: bool = False) -> None:
    (_CPU_ALGORITHMS if cpu else _DEVICE_ALGORITHMS)[name] = fn
    if pallas:
        _PALLAS_ALGORITHMS.add(name)


def is_pallas_algorithm(name: str) -> bool:
    """True when ``name``'s device path contains a Pallas kernel — such
    algorithms must be sharded via shard_map, not the GSPMD partitioner
    (see ``parallel/sharded.py``)."""
    _populate()
    return name in _PALLAS_ALGORITHMS


def _populate() -> None:
    if _DEVICE_ALGORITHMS:
        _populate_native()
        return
    from cuda_matrix_inversion_tpu.ops import cpu_reference, xla

    # device paths — analog of the reference's *_batched_device family
    register_inverse("lu", xla.inverse_lu)
    register_inverse("cholesky", xla.inverse_cholesky)
    from cuda_matrix_inversion_tpu.ops import newton_schulz

    register_inverse("newton_schulz", newton_schulz.inverse_newton_schulz)
    # Fixed-schedule lanes: one Triton program per matrix for n <= 128,
    # the same schedule in plain XLA above (ops/newton_schulz.py).
    register_inverse("newton_schulz_pallas",
                     newton_schulz.inverse_newton_schulz_pallas, pallas=True)
    # SPD-only fast paths (caller-asserted, like the Cholesky entries):
    # X0 = I/‖A‖∞ halves the contraction rounds vs the Pan-Schreiber start.
    # _pallas is the fixed-schedule speed path (κ ≲ 30); the adaptive one
    # keeps the residual-monitored while_loop for unknown conditioning.
    register_inverse("newton_schulz_spd_pallas",
                     functools.partial(newton_schulz.inverse_newton_schulz_pallas,
                                       init="spd"),
                     pallas=True)
    register_inverse("newton_schulz_spd",
                     functools.partial(newton_schulz.inverse_newton_schulz,
                                       init="spd"))
    # κ ≲ 10 fast lane (caller-asserted, narrower than the κ ≲ 30 entry):
    # 4 scaled bf16 rounds from a µ ≥ 0.03 interval (vs 6 from 0.01).  An
    # all-3-pass polish is not enough: its 2⁻¹⁷·κ residual floor sits at
    # ~1e-4 at κ=10, on the gate.  The reference's diagonally-
    # dominant fixture class (generate_inverse_matrices.m:8-18) lives here
    # at κ ≈ 1.5-3.
    register_inverse("newton_schulz_spd10_pallas",
                     functools.partial(newton_schulz.inverse_newton_schulz_pallas,
                                       init="spd", lo_iters=4, hi_iters=2,
                                       mu_min=0.03),
                     pallas=True)
    # κ ≲ 500 GENERAL-matrix lane: every product is the 3-pass bf16
    # split (~2⁻¹⁷ relative), extending the pan domain past the square_5
    # fixture class (κ ≤ 4·dim) — the matmul-only alternative to LU for
    # moderately-conditioned nonsymmetric batches.
    register_inverse("newton_schulz_pan500_pallas",
                     functools.partial(newton_schulz.inverse_newton_schulz_pallas,
                                       precision="split3"),
                     pallas=True)
    from cuda_matrix_inversion_tpu.ops import double_single

    # fp64-class tier on fp32 inputs: XLA LU seed + double-single
    # refinement with exact bf16-digit residuals.  iters=3 (unrolled —
    # reaches the ds floor through κ ~ 2e4 from the pivoted-LU seed);
    # adaptive callers use inverse_hiacc_ds directly.
    register_inverse("lu_hiacc",
                     functools.partial(double_single.inverse_hiacc,
                                       algorithm="lu", iters=3))

    # CPU oracle paths — analog of inverse_lu_blas / inverse_chol_blas
    register_inverse("lu_cpu", cpu_reference.inverse_lu, cpu=True)
    register_inverse("cholesky_cpu", cpu_reference.inverse_cholesky, cpu=True)
    register_inverse("gauss_cpu", cpu_reference.inverse_gauss_jordan, cpu=True)

    _populate_native()


def _populate_native() -> None:
    # native C++ LAPACK+OpenMP oracle (the true inverse.c equivalent).
    # Retried on every _populate(): the gitignored .so can be stale at
    # first import (a fresh checkout stamps the sources newer) and get
    # rebuilt later in the same process via native.build.ensure_built —
    # oracle.available() is a cheap stat until the load succeeds.
    if "lu_native_cpu" in _CPU_ALGORITHMS:
        return
    try:
        from cuda_matrix_inversion_tpu.native import oracle

        if oracle.available():
            register_inverse("lu_native_cpu", oracle.inverse_lu, cpu=True)
            register_inverse("cholesky_native_cpu", oracle.inverse_cholesky, cpu=True)
    except Exception:
        pass


def get_inverse_algorithm(name: str) -> Callable:
    _populate()
    if name in _DEVICE_ALGORITHMS:
        return _DEVICE_ALGORITHMS[name]
    if name in _CPU_ALGORITHMS:
        return _CPU_ALGORITHMS[name]
    raise KeyError(
        f"unknown inversion algorithm {name!r}; have "
        f"{sorted(_DEVICE_ALGORITHMS) + sorted(_CPU_ALGORITHMS)}"
    )


def list_inverse_algorithms(cpu: bool | None = None):
    _populate()
    if cpu is True:
        return sorted(_CPU_ALGORITHMS)
    if cpu is False:
        return sorted(_DEVICE_ALGORITHMS)
    return sorted(_DEVICE_ALGORITHMS) + sorted(_CPU_ALGORITHMS)
