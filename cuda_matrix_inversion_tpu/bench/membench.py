"""Memory/transfer micro-benchmark CLI.

Reference counterpart: ``src/bench.cu`` — ``bench NUM_REPS NUM_ELEMS
NUM_ARRAYS`` (``bench.cu:207-222``) timing cudaMalloc/free and pageable vs
pinned vs pitched-2D H2D/D2H bandwidth.  The analogs measured here:

* host→HBM transfer (``jax.device_put``) — the PCIe-H2D analog
* HBM→host fetch (``jax.device_get``) — the D2H analog
* device-side buffer allocation (zeros) and HBM↔HBM copy bandwidth
* donated-buffer update (the analog of reusing pinned buffers)

The reference's pinned-vs-pageable distinction is the runtime's choice
under JAX (it stages all transfers); pitched 2D layout is owned by XLA.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _gb(nbytes: float) -> float:
    return nbytes / 1e9


def _bw(nbytes: int, seconds: float) -> float:
    return _gb(nbytes) / seconds if seconds > 0 else float("inf")


def run(num_reps: int, num_elems: int, num_arrays: int, stream=None) -> dict:
    import jax
    import jax.numpy as jnp

    stream = stream or sys.stdout
    host = [np.random.default_rng(i).random(num_elems, dtype=np.float32) for i in range(num_arrays)]
    nbytes = 4 * num_elems * num_arrays
    results = {}

    # --- allocation (ref benchmarkMalloc, bench.cu:26-62) ---
    t0 = time.monotonic()
    for _ in range(num_reps):
        bufs = [jnp.zeros(num_elems, dtype=jnp.float32) for _ in range(num_arrays)]
        jax.block_until_ready(bufs)
    alloc_s = (time.monotonic() - t0) / num_reps
    results["alloc_ms"] = alloc_s * 1e3
    print(f"device alloc: {alloc_s*1e3:.3f} ms for {num_arrays} x {num_elems} f32", file=stream)

    # --- H2D (ref benchmarkTransfer, bench.cu:64-110) ---
    t0 = time.monotonic()
    for _ in range(num_reps):
        dev = [jax.device_put(h) for h in host]
        jax.block_until_ready(dev)
    h2d_s = (time.monotonic() - t0) / num_reps
    results["h2d_GBps"] = _bw(nbytes, h2d_s)
    print(f"host->HBM: {results['h2d_GBps']:.2f} GB/s ({h2d_s*1e3:.3f} ms)", file=stream)

    # --- D2H ---
    t0 = time.monotonic()
    for _ in range(num_reps):
        out = [np.asarray(jax.device_get(d)) for d in dev]
    d2h_s = (time.monotonic() - t0) / num_reps
    results["d2h_GBps"] = _bw(nbytes, d2h_s)
    print(f"HBM->host: {results['d2h_GBps']:.2f} GB/s ({d2h_s*1e3:.3f} ms)", file=stream)
    del out

    # --- HBM<->HBM copy bandwidth (read+write) ---
    big = jnp.concatenate([jnp.asarray(h) for h in host])
    copy = jax.jit(lambda x: x + 0.0)
    copy(big).block_until_ready()
    t0 = time.monotonic()
    for _ in range(num_reps):
        big2 = copy(big)
        big2.block_until_ready()
    dd_s = (time.monotonic() - t0) / num_reps
    results["hbm_copy_GBps"] = _bw(2 * nbytes, dd_s)
    print(f"HBM copy (r+w): {results['hbm_copy_GBps']:.2f} GB/s", file=stream)

    # --- device-to-device copy over whatever joins the devices
    # (multi-device only; the reference's PCIe bandwidth table,
    # report.tex:91, has no device-to-device analog) ---
    if len(jax.devices()) > 1:
        results["d2d_ring_GBps"] = d2d_ring_bandwidth(num_elems)
        print(f"device-to-device ring (ppermute): "
              f"{results['d2d_ring_GBps']:.2f} GB/s across "
              f"{len(jax.devices())} devices", file=stream)

    # --- donated-buffer update (pinned-reuse analog, bench.cu:112-156) ---
    upd = jax.jit(lambda x: x * 1.000001, donate_argnums=0)
    buf = jnp.asarray(host[0])
    buf = upd(buf)
    buf.block_until_ready()
    t0 = time.monotonic()
    for _ in range(num_reps):
        buf = upd(buf)
    buf.block_until_ready()
    don_s = (time.monotonic() - t0) / num_reps
    results["donated_update_GBps"] = _bw(2 * 4 * num_elems, don_s)
    print(f"donated in-place update: {results['donated_update_GBps']:.2f} GB/s", file=stream)

    return results


def d2d_ring_bandwidth(num_elems: int) -> float:
    """Ring-shift bandwidth over the device mesh: every device copies its
    shard to the next device per step (lax.ppermute under shard_map).
    Uses the chained-slope timer, which cancels per-call dispatch."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cuda_matrix_inversion_tpu.bench.timing import chained_op_seconds
    from cuda_matrix_inversion_tpu.parallel.mesh import BATCH_AXIS, batch_mesh

    devs = jax.devices()
    mesh = batch_mesh(len(devs))
    perm = [(i, (i + 1) % len(devs)) for i in range(len(devs))]

    def shift(x):
        f = lambda s: jax.lax.ppermute(s, BATCH_AXIS, perm)  # noqa: E731
        return jax.shard_map(f, mesh=mesh, in_specs=P(BATCH_AXIS),
                             out_specs=P(BATCH_AXIS))(x)

    n = max(num_elems - num_elems % len(devs), len(devs))
    x = jnp.arange(n, dtype=jnp.float32)
    sec = chained_op_seconds(shift, x, iters=8, trials=3)
    return _bw(4 * n, max(sec, 1e-12))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="membench",
        description="host<->device bandwidth probe (JAX rebuild of src/bench.cu)",
    )
    p.add_argument("num_reps", type=int)
    p.add_argument("num_elems", type=int)
    p.add_argument("num_arrays", type=int)
    from cuda_matrix_inversion_tpu.utils.backend import (
        backend_argument,
        pin_backend,
    )

    backend_argument(p)
    args = p.parse_args(argv)

    from cuda_matrix_inversion_tpu.utils.cache import enable_compilation_cache

    pin_backend(args.backend)
    enable_compilation_cache()
    run(args.num_reps, args.num_elems, args.num_arrays)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
