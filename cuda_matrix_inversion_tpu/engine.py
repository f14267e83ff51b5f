"""Serving engine: pre-compiled, shape-bucketed batched linear algebra.

The production-runtime layer the reference never needed (its binaries run
for seconds; SURVEY §5 "checkpoint/resume: none").  For serving, the
latency killers on an accelerator are (re)compilation and shape churn;
the engine removes both:

* a fixed set of (batch-bucket, dim-bucket) entry points is compiled
  once at startup (``warmup()``), backed by the persistent compilation
  cache (`utils/cache.py`) so process restarts are cheap;
* requests of any batch size / matrix size are padded to the nearest
  registered bucket (identity-block padding — exact un-padding) and
  dispatched to the pre-compiled executable — no tracing at serve time;
* GP requests use the same machinery via ``gp_mean_variance``.

Thread-safe for concurrent callers (JAX dispatch is); no host round
trips inside a request beyond input/output transfer.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Sequence, Tuple

import numpy as np

DEFAULT_DIM_BUCKETS = (8, 16, 32, 64, 128, 256, 512)
DEFAULT_BATCH_BUCKETS = (8, 32, 128, 512, 2048)


def _round_up(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    raise ValueError(f"{value} exceeds largest bucket {buckets[-1]}")


class _BucketedEngine:
    """Shared machinery: bucket rounding, the (batch, dim) → compiled
    executable cache, warmup, and identity/zero padding helpers.
    Subclasses implement ``_lower(batch_b, dim_b) -> compiled``."""

    def __init__(self, dim_buckets=DEFAULT_DIM_BUCKETS,
                 batch_buckets=DEFAULT_BATCH_BUCKETS, dtype="float32"):
        from cuda_matrix_inversion_tpu.utils.cache import enable_compilation_cache

        enable_compilation_cache()
        self.dim_buckets = dim_buckets
        self.batch_buckets = batch_buckets
        self.dtype = dtype
        self._compiled: Dict[Tuple[int, int], object] = {}
        self._lock = threading.Lock()

    def _get_or_compile(self, cache: Dict, batch_b: int, dim_b: int, lower):
        """Check-compile-store against ``cache`` (shared by the cold and
        warm executable caches; compile runs outside the lock)."""
        key = (batch_b, dim_b)
        with self._lock:
            exe = cache.get(key)
        if exe is not None:
            return exe
        exe = lower(batch_b, dim_b)
        with self._lock:
            cache[key] = exe
        return exe

    def _get_executable(self, batch_b: int, dim_b: int):
        return self._get_or_compile(self._compiled, batch_b, dim_b, self._lower)

    def _buckets_for(self, batch: int, n: int) -> Tuple[int, int]:
        return (_round_up(batch, self.batch_buckets),
                _round_up(n, self.dim_buckets))

    def warmup(self, shapes: Sequence[Tuple[int, int]]) -> None:
        """Pre-compile for (batch, n) shapes (bucketed) before serving."""
        for batch, n in shapes:
            self._get_executable(*self._buckets_for(batch, n))

    @property
    def compiled_shapes(self):
        with self._lock:
            return sorted(self._compiled)

    # -- padding helpers ---------------------------------------------------
    def _pad_square(self, m: np.ndarray, batch_b: int, dim_b: int,
                    scale=None) -> np.ndarray:
        """(batch, n, n) → (batch_b, dim_b, dim_b); identity blocks keep
        every padded matrix invertible and un-padding exact.  ``scale``
        (batch,) multiplies each matrix's identity block."""
        batch, n = m.shape[0], m.shape[-1]
        dt = np.dtype(self.dtype)
        out = np.zeros((batch_b, dim_b, dim_b), dt)
        out[:batch, :n, :n] = m
        if dim_b > n:
            out[:, n:, n:] = np.eye(dim_b - n, dtype=dt)
            if scale is not None:
                out[:batch, n:, n:] *= scale[:, None, None].astype(dt)
        if batch_b > batch:
            out[batch:] = np.eye(dim_b, dtype=dt)
        return out

    def _pad_vec(self, v: np.ndarray, batch_b: int, dim_b: int) -> np.ndarray:
        batch, n = v.shape[0], v.shape[1]
        return np.pad(v.reshape(batch, n, 1),
                      ((0, batch_b - batch), (0, dim_b - n), (0, 0)))


class InversionEngine(_BucketedEngine):
    """Pre-compiled batched-inversion service.

    The default cold route is ``lu`` (batched getrf through XLA): any
    nonsingular input with κ·ε₃₂ ≲ 1 holds the gate, where the
    Newton–Schulz lanes hold it only inside their stated κ domains.
    Pick an NS lane by name for a batch known to sit in its domain.

    Example::

        eng = InversionEngine()
        eng.warmup([(100, 128)])          # compile ahead of serving
        out = eng.inverse(batch)           # (b, n, n) ndarray in/out
    """

    def __init__(self, algorithm: str = "lu",
                 warm_precision: str | None = None, **kw):
        super().__init__(**kw)
        self.algorithm = algorithm
        # warm-refinement precision: the bf16 warm kernel's X·R update
        # stalls at 2⁻⁹·κ·‖R‖ (κ ≲ 30); engines serving the κ ≲ 500
        # general class (the pan500 lane) refine through the 3-pass
        # split instead.  Defaults to match the cold algorithm's domain.
        if warm_precision is None:
            warm_precision = ("split3" if "pan500" in algorithm else "bf16")
        if warm_precision not in ("bf16", "split3"):
            raise ValueError(f"warm_precision must be 'bf16' or 'split3', "
                             f"got {warm_precision!r}")
        self.warm_precision = warm_precision
        self._compiled_warm: Dict[Tuple[int, int], object] = {}
        self._compiled_warm_check: Dict[Tuple[int, int], object] = {}

    def _lower(self, batch_b: int, dim_b: int):
        import jax

        from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

        fn = get_inverse_algorithm(self.algorithm)
        spec = jax.ShapeDtypeStruct((batch_b, dim_b, dim_b), np.dtype(self.dtype))
        return jax.jit(fn).lower(spec).compile()

    def warmup_warm(self, shapes) -> None:
        """Pre-compile the warm-start refinement path for (batch, n) shapes."""
        for batch, n in shapes:
            batch_b, dim_b = self._buckets_for(batch, n)
            self._get_or_compile(self._compiled_warm, batch_b, dim_b,
                                 self._lower_warm)

    def _lower_warm(self, batch_b: int, dim_b: int):
        import jax

        from cuda_matrix_inversion_tpu.ops.newton_schulz import (
            inverse_newton_schulz_warm,
        )

        spec = jax.ShapeDtypeStruct((batch_b, dim_b, dim_b), np.dtype(self.dtype))
        fn = functools.partial(inverse_newton_schulz_warm,
                               precision=self.warm_precision)
        return jax.jit(fn).lower(spec, spec).compile()

    def _lower_warm_check(self, batch_b: int, dim_b: int):
        import jax
        import jax.numpy as jnp

        from cuda_matrix_inversion_tpu.ops.newton_schulz import (
            inverse_newton_schulz_warm,
        )
        from cuda_matrix_inversion_tpu.ops.precision import matmul

        def fn(a, x0):
            x = inverse_newton_schulz_warm(a, x0,
                                           precision=self.warm_precision)
            eye = jnp.eye(dim_b, dtype=x.dtype)
            ax = matmul(a, x)
            return x, jnp.max(jnp.sum(jnp.abs(ax - eye), axis=-1))

        spec = jax.ShapeDtypeStruct((batch_b, dim_b, dim_b), np.dtype(self.dtype))
        return jax.jit(fn).lower(spec, spec).compile()

    def inverse_warm(self, a: np.ndarray, prev_inv: np.ndarray,
                     check: bool = False, tol: float = 1e-3) -> np.ndarray:
        """Refine ``prev_inv`` (the inverse of a nearby batch) for ``a``.

        The serving pattern for slowly-varying systems (per-timestep
        sensor covariances): fewer rounds than a cold ``inverse`` while
        the relative change δ satisfies δ·κ(A) ≲ 0.3 — past that, call
        ``inverse`` again.  Shapes must match.

        ``check=True`` also computes ‖AX − I‖∞ on device (one extra
        fp32 matmul) and raises ``LinAlgError`` when it exceeds
        ``tol`` — the warm refinement DIVERGES (to finite garbage, so a
        finiteness check cannot catch it) when the batch jumped too far
        from the one ``prev_inv`` belonged to.
        """
        import jax

        a = np.ascontiguousarray(np.asarray(a, dtype=self.dtype))
        prev = np.ascontiguousarray(np.asarray(prev_inv, dtype=self.dtype))
        if a.ndim == 2:
            a, prev = a[None], prev[None] if prev.ndim == 2 else prev
        if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
            raise ValueError(f"expected (batch, n, n), got {a.shape}")
        if a.shape != prev.shape:
            raise ValueError(f"mismatched shapes {a.shape} vs {prev.shape}")
        batch, n = a.shape[0], a.shape[-1]
        if batch == 0:
            return a.copy()
        batch_b, dim_b = self._buckets_for(batch, n)
        # separate caches: _compiled holds the cold executables and feeds
        # compiled_shapes, which sorts homogeneous (batch, dim) keys
        if check:
            exe = self._get_or_compile(self._compiled_warm_check, batch_b,
                                       dim_b, self._lower_warm_check)
        else:
            exe = self._get_or_compile(self._compiled_warm, batch_b, dim_b,
                                       self._lower_warm)
        pa = self._pad_square(a, batch_b, dim_b)
        px = self._pad_square(prev, batch_b, dim_b)  # identity pads: X=A⁻¹
        result = exe(jax.device_put(pa), jax.device_put(px))
        if check:
            out, res = result
            res = float(np.asarray(jax.device_get(res)))
            if not res < tol:  # NaN also fails this comparison
                raise np.linalg.LinAlgError(
                    f"warm-start refinement diverged: ||AX - I||_inf = {res:.3e}"
                    f" > {tol:.1e} — the batch moved too far from prev_inv's;"
                    " recompute with inverse()")
        else:
            out = result
        out = np.asarray(jax.device_get(out))
        return np.ascontiguousarray(out[:batch, :n, :n])

    def inverse(self, a: np.ndarray, check: bool = False) -> np.ndarray:
        """Invert a (batch, n, n) batch; any size within the buckets."""
        import jax

        a = np.ascontiguousarray(np.asarray(a, dtype=self.dtype))
        if a.ndim == 2:
            a = a[None]
        if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
            raise ValueError(f"expected (batch, n, n), got {a.shape}")
        batch, n = a.shape[0], a.shape[-1]
        if batch == 0:
            return a.copy()
        batch_b, dim_b = self._buckets_for(batch, n)
        # pad block s·I, s = min(‖A‖₁, ‖A‖∞): the padded matrix keeps A's
        # norms, so the Newton–Schulz lanes start at the scaling their
        # schedules were calibrated on, whatever A's scale
        s = np.minimum(np.abs(a).sum(-1).max(-1), np.abs(a).sum(-2).max(-1))
        padded = self._pad_square(a, batch_b, dim_b,
                                  scale=np.where(s > 0, s, 1.0))
        exe = self._get_executable(batch_b, dim_b)
        out = np.asarray(jax.device_get(exe(jax.device_put(padded))))
        result = out[:batch, :n, :n]
        if check:
            finite = np.isfinite(result).all(axis=(1, 2))
            if not finite.all():
                from cuda_matrix_inversion_tpu.ops.host_api import SingularBatchError

                raise SingularBatchError(np.nonzero(~finite)[0])
        return np.ascontiguousarray(result)


class GPEngine(_BucketedEngine):
    """Pre-compiled GP mean/variance service (same bucketing strategy).

    For slowly-varying per-timestep systems (the reference's sensor
    workload, ``README.md:41-44``), ``mean_variance_warm`` refines the
    previous timestep's K⁻¹ instead of solving cold — the GP analog of
    ``InversionEngine.inverse_warm``.
    """

    def __init__(self, method: str = "solve", **kw):
        super().__init__(**kw)
        self.method = method
        self._compiled_gp_warm: Dict[Tuple[int, int], object] = {}
        self._compiled_fit: Dict[Tuple[int, int, int, float], object] = {}

    def _lower(self, batch_b: int, dim_b: int):
        import jax

        from cuda_matrix_inversion_tpu.models.gp import gp_mean_variance

        dt = np.dtype(self.dtype)
        vec = jax.ShapeDtypeStruct((batch_b, dim_b, 1), dt)
        mat = jax.ShapeDtypeStruct((batch_b, dim_b, dim_b), dt)
        scl = jax.ShapeDtypeStruct((batch_b, 1, 1), dt)
        fn = lambda a, b, c, d, e: gp_mean_variance(  # noqa: E731
            a, b, c, d, e, method=self.method)
        return jax.jit(fn).lower(vec, mat, vec, vec, scl).compile()

    def mean_variance(self, a, b, c, d, e):
        """Batched GP mean/variance; returns two (batch, 1, 1) ndarrays."""
        import jax

        dt = np.dtype(self.dtype)
        a, b, c, d, e = (np.ascontiguousarray(np.asarray(x, dtype=dt))
                         for x in (a, b, c, d, e))
        batch, n = b.shape[0], b.shape[-1]
        if batch == 0:
            z = np.zeros((0, 1, 1), dt)
            return z, z.copy()
        batch_b, dim_b = self._buckets_for(batch, n)

        bp = self._pad_square(b, batch_b, dim_b)
        ap = self._pad_vec(a, batch_b, dim_b)
        cp = self._pad_vec(c, batch_b, dim_b)
        dp = self._pad_vec(d, batch_b, dim_b)
        ep = np.pad(e.reshape(batch, 1, 1), ((0, batch_b - batch), (0, 0), (0, 0)))

        exe = self._get_executable(batch_b, dim_b)
        mean, var = exe(*(jax.device_put(x) for x in (ap, bp, cp, dp, ep)))
        return (np.asarray(jax.device_get(mean))[:batch],
                np.asarray(jax.device_get(var))[:batch])

    # -- hyper-parameter fitting --------------------------------------------
    def fit(self, b, c, d, steps: int = 150, lr: float = 0.05):
        """Batch-bucketed hyper-parameter fit (``models/gp_fit.py``) —
        learn per-system (log amp, log noise) through the engine's
        pre-compiled executable machinery.

        Only the BATCH axis is bucketed: padded systems carry loss
        weight 0, so their frozen θ never touches the loss or the
        convergence trace.  The dim axis is served at its exact size —
        pre-scaling dim padding is NOT exact for the fit (an identity
        block appended to B is multiplied by e^{2θ_amp}, making the pad
        block's log-determinant θ-dependent and biasing the amplitude
        gradient by −pad); the LML kernels' internal tile padding
        happens after scaling, which is exact.  Returns a
        ``GPFitResult`` of host arrays sliced to the real batch.
        """
        import jax

        from cuda_matrix_inversion_tpu.models.gp_fit import GPFitResult

        dt = np.dtype(self.dtype)
        b, c, d = (np.ascontiguousarray(np.asarray(x, dtype=dt))
                   for x in (b, c, d))
        batch, n = b.shape[0], b.shape[-1]
        if batch == 0:
            z = np.zeros((0,), dt)
            return GPFitResult(z, z.copy(), z.copy(),
                               np.zeros((steps,), dt))
        batch_b = _round_up(batch, self.batch_buckets)
        bp = np.zeros((batch_b, n, n), dt)
        bp[:batch] = b
        bp[batch:] = np.eye(n, dtype=dt)
        cp = np.zeros((batch_b, n, 1), dt)
        cp[:batch] = c.reshape(batch, n, 1)
        dp = np.zeros((batch_b, n, 1), dt)
        dp[:batch] = d.reshape(batch, n, 1)
        w = np.zeros((batch_b,), dt)
        w[:batch] = 1.0

        key = (batch_b, n, steps, lr)
        with self._lock:
            exe = self._compiled_fit.get(key)
        if exe is None:
            exe = self._lower_fit(batch_b, n, steps, lr)
            with self._lock:
                self._compiled_fit[key] = exe
        res = exe(*(jax.device_put(x) for x in (bp, cp, dp, w)))
        return GPFitResult(
            np.asarray(jax.device_get(res.log_amp))[:batch],
            np.asarray(jax.device_get(res.log_noise))[:batch],
            np.asarray(jax.device_get(res.lml))[:batch],
            np.asarray(jax.device_get(res.lml_path)),
        )

    def _lower_fit(self, batch_b: int, dim_b: int, steps: int, lr: float):
        import jax

        from cuda_matrix_inversion_tpu.models.gp_fit import fit_gp_scales

        dt = np.dtype(self.dtype)
        vec = jax.ShapeDtypeStruct((batch_b, dim_b, 1), dt)
        mat = jax.ShapeDtypeStruct((batch_b, dim_b, dim_b), dt)
        wshape = jax.ShapeDtypeStruct((batch_b,), dt)
        fn = lambda b_, c_, d_, w_: fit_gp_scales(  # noqa: E731
            b_, c_, d_, steps=steps, lr=lr, weights=w_)
        return jax.jit(fn).lower(mat, vec, vec, wshape).compile()

    # -- warm serving --------------------------------------------------------
    def _lower_gp_warm(self, batch_b: int, dim_b: int):
        import jax

        from cuda_matrix_inversion_tpu.models.gp import gp_mean_variance_warm

        dt = np.dtype(self.dtype)
        vec = jax.ShapeDtypeStruct((batch_b, dim_b, 1), dt)
        mat = jax.ShapeDtypeStruct((batch_b, dim_b, dim_b), dt)
        scl = jax.ShapeDtypeStruct((batch_b, 1, 1), dt)
        return jax.jit(gp_mean_variance_warm).lower(
            vec, mat, vec, vec, scl, mat).compile()

    def warmup_warm(self, shapes) -> None:
        """Pre-compile the warm GP path for (batch, n) shapes."""
        for batch, n in shapes:
            batch_b, dim_b = self._buckets_for(batch, n)
            self._get_or_compile(self._compiled_gp_warm, batch_b, dim_b,
                                 self._lower_gp_warm)

    def mean_variance_warm(self, a, b, c, d, e, prev_kinv):
        """Warm GP mean/variance: refine ``prev_kinv`` — the ``kinv``
        returned by the previous call for a nearby batch — instead of a
        cold solve.  Returns ``(mean, var, kinv)``; chain ``kinv`` into
        the next timestep.  Valid while the relative drift δ of
        K = B + diag(c) satisfies δ·κ(K) ≲ 0.3 (same domain as
        ``InversionEngine.inverse_warm``); start the chain with a cold
        inverse of K or a first warm call seeded with a cold K⁻¹.
        """
        import jax

        dt = np.dtype(self.dtype)
        a, b, c, d, e, prev_kinv = (
            np.ascontiguousarray(np.asarray(x, dtype=dt))
            for x in (a, b, c, d, e, prev_kinv))
        batch, n = b.shape[0], b.shape[-1]
        if batch == 0:
            z = np.zeros((0, 1, 1), dt)
            return z, z.copy(), np.zeros((0, n, n), dt)
        if prev_kinv.shape != b.shape:
            raise ValueError(
                f"prev_kinv shape {prev_kinv.shape} must match b {b.shape}")
        batch_b, dim_b = self._buckets_for(batch, n)

        bp = self._pad_square(b, batch_b, dim_b)
        xp = self._pad_square(prev_kinv, batch_b, dim_b)  # identity pad: X=K⁻¹
        ap = self._pad_vec(a, batch_b, dim_b)
        cp = self._pad_vec(c, batch_b, dim_b)
        dp = self._pad_vec(d, batch_b, dim_b)
        ep = np.pad(e.reshape(batch, 1, 1), ((0, batch_b - batch), (0, 0), (0, 0)))

        exe = self._get_or_compile(self._compiled_gp_warm, batch_b, dim_b,
                                   self._lower_gp_warm)
        mean, var, kinv = exe(*(jax.device_put(x)
                                for x in (ap, bp, cp, dp, ep, xp)))
        return (np.asarray(jax.device_get(mean))[:batch],
                np.asarray(jax.device_get(var))[:batch],
                np.ascontiguousarray(
                    np.asarray(jax.device_get(kinv))[:batch, :n, :n]))
