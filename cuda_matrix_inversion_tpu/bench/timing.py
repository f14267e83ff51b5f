"""Device-resident timing helpers for the sweep CLIs.

On the GPU ``block_until_ready`` synchronizes with the device, so a
synchronized wall-clock median (what ``bench.py`` and ``chip_smoke.py``
report) is the end-to-end time of one call.  The helpers here measure
something narrower — the device time of the op with per-call dispatch
cancelled out:

1. run the op ``k`` times *inside* one compiled ``lax.fori_loop`` /
   ``lax.scan`` with a genuine data dependency between iterations (no
   loop-invariant hoisting possible);
2. reduce the result to a scalar inside jit and ``device_get`` it;
3. time k and 2k iterations and report the slope ``(t2k − tk)/k``,
   cancelling dispatch/transfer overhead.

The loop's control flow reads its predicate on the host once per
iteration on the GPU; that cost is inside each slope sample.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def _fetch_scalar(x) -> float:
    return float(np.asarray(jax.device_get(x)))


def chained_op_samples(
    fn: Callable,
    x0: jnp.ndarray,
    iters: int = 16,
    trials: int = 5,
) -> list[float]:
    """Per-call seconds samples for an endomorphic op (``fn(x)`` shaped
    like ``x``, e.g. batched inversion: inv∘inv chains exactly).

    Each sample is one slope measurement ``(t(2k) − t(k)) / k``; compiling
    happens once up front (callers wanting Welford stats over reps should
    call this once with ``trials=reps``, not in a loop — each call
    builds fresh jit closures and would recompile).
    """

    def make(k):
        def run(x):
            y = jax.lax.fori_loop(0, k, lambda i, x: fn(x), x)
            return jnp.sum(y)

        return jax.jit(run)

    run_k = make(iters)
    run_2k = make(2 * iters)
    x0 = jax.device_put(x0)
    _fetch_scalar(run_k(x0))  # compile
    _fetch_scalar(run_2k(x0))

    deltas = []
    for _ in range(trials):
        t0 = time.perf_counter()
        _fetch_scalar(run_k(x0))
        t1 = time.perf_counter()
        _fetch_scalar(run_2k(x0))
        t2 = time.perf_counter()
        deltas.append(((t2 - t1) - (t1 - t0)) / iters)
    return deltas


def chained_op_seconds(fn, x0, iters: int = 16, trials: int = 5) -> float:
    """Median of :func:`chained_op_samples`."""
    return float(np.median(chained_op_samples(fn, x0, iters, trials)))


def chained_op_samples_robust(
    fn: Callable,
    x0,
    iters: int = 4,
    trials: int = 5,
    retry_iters: int = 32,
) -> list[float]:
    """:func:`chained_op_samples`, retried once with longer chains when the
    median slope is non-positive (host jitter can make short-chain slopes
    negative for ~0.1 ms ops).  A still-non-positive median after the retry
    is the caller's to handle — it means the op is below the measurement
    floor even at ``retry_iters``."""
    samples = chained_op_samples(fn, x0, iters, trials)
    if float(np.median(samples)) <= 0.0:
        samples = chained_op_samples(fn, x0, retry_iters, trials)
    return samples


def looped_pipeline_samples(
    fn: Callable,
    args: Sequence,
    iters: int = 16,
    trials: int = 5,
    perturb: int = 0,
) -> list[float]:
    """Per-call seconds for an arbitrary pipeline ``fn(*args)``.

    Dependency is enforced by carrying a scalar that perturbs
    ``args[perturb]`` each iteration (×(1+s·1e-30): numerically a no-op,
    but the compiler cannot hoist the body).  Cost of the extra
    elementwise pass over that operand is included — i.e. reported times
    are slightly conservative.
    """
    args = [jax.device_put(a) for a in args]

    def make(k):
        def run(*xs):
            def body(carry, _):
                perturbed = list(xs)
                perturbed[perturb] = xs[perturb] * (1.0 + carry * 1e-30)
                out = fn(*perturbed)
                leaves = [l for l in jax.tree.leaves(out)
                          if jnp.issubdtype(l.dtype, jnp.floating)]
                s = sum(jnp.sum(l.astype(jnp.float32)) for l in leaves)
                return carry + s * 1e-30, None

            carry, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=k)
            return carry

        return jax.jit(run)

    run_k = make(iters)
    run_2k = make(2 * iters)
    _fetch_scalar(run_k(*args))
    _fetch_scalar(run_2k(*args))

    deltas = []
    for _ in range(trials):
        t0 = time.perf_counter()
        _fetch_scalar(run_k(*args))
        t1 = time.perf_counter()
        _fetch_scalar(run_2k(*args))
        t2 = time.perf_counter()
        deltas.append(((t2 - t1) - (t1 - t0)) / iters)
    return deltas


def looped_pipeline_seconds(fn, args, iters: int = 16, trials: int = 5,
                            perturb: int = 0) -> float:
    """Median of :func:`looped_pipeline_samples`."""
    return float(np.median(
        looped_pipeline_samples(fn, args, iters, trials, perturb)))


def enqueue_slope_seconds(
    fn: Callable,
    args: Sequence,
    n1: int = 8,
    n2: int = 32,
    trials: int = 3,
) -> float:
    """Per-call seconds via the enqueue-slope method — NO extra compiles.

    Enqueue n independent calls (async dispatch is cheap), fetch a scalar
    of the last result (the device executes one stream's queue in order,
    so the fetch waits for all n), and take the slope between n1 and n2.
    Use this instead of the chained timers for ops whose compile is
    expensive (e.g. nested while_loops) — the jitted fn is compiled once
    by the first call and reused.
    """
    fn = jax.jit(fn) if not hasattr(fn, "lower") else fn
    args = [jax.device_put(a) for a in args]

    def run(n):
        out = None
        for _ in range(n):
            out = fn(*args)
        leaf = jax.tree.leaves(out)[0]
        return float(np.asarray(jax.device_get(leaf)).ravel()[0])

    run(1)  # compile + warm
    deltas = []
    for _ in range(trials):
        t0 = time.perf_counter()
        run(n1)
        t1 = time.perf_counter()
        run(n2)
        t2 = time.perf_counter()
        deltas.append(((t2 - t1) - (t1 - t0)) / (n2 - n1))
    return float(np.median(deltas))


def wallclock_seconds(thunk: Callable[[], object], reps: int = 10) -> float:
    """Plain wall-clock median including a real device_get of the result —
    for end-to-end (transfers-included) measurements."""
    thunk()  # warmup
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = thunk()
        jax.tree.map(lambda l: np.asarray(jax.device_get(l)), out)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))
