"""Multi-host (multi-process) mesh construction and batch sharding.

The reference is single-GPU, single-process; the four GPUs of one host
are driven by one process too.  This module is the structural story for
the next scale step — several hosts and multi-host CPU ingest:

* each host process owns its local devices (``jax.local_devices()``);
* ``jax.distributed.initialize`` stitches the processes into one global
  runtime (given its ``coordinator_address``, ``num_processes`` and
  ``process_id``: nothing in the environment announces a cluster);
* the batch axis — still the only parallelism axis this workload has —
  shards over the GLOBAL device list, and each process feeds only its
  local shard through ``jax.make_array_from_process_local_data`` (the
  host-side ingest never materializes the global batch anywhere);
* the math still needs no collectives, so multi-host costs nothing on
  the compute path — the partitioned program is identical to the
  single-host one.

Tested structurally by ``tests/test_multihost.py``: two coordinated
CPU processes × 4 virtual devices each build an 8-device global mesh,
invert a globally-sharded batch, and every process verifies its OWN
addressable shards against the host oracle.  This stays out of the
driver's ``dryrun_multichip`` contract (that remains single-process by
design).
"""

from __future__ import annotations

import numpy as np

from cuda_matrix_inversion_tpu.parallel.mesh import batch_mesh, batch_sharding


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """Join this process to the global JAX runtime.  Must run before any
    backend initialization (same rule as the virtual-device flags)."""
    import jax

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_batch_mesh():
    """1-D batch mesh over the GLOBAL device list (all processes)."""
    return batch_mesh()


def local_batch_slice(global_batch: int) -> slice:
    """The half-open row range of the global batch this process feeds.

    Defined by device order: the global sharding places row block i on
    global device i, and each process owns a contiguous run of the
    global device list, so the process's rows are its devices' blocks.
    """
    import jax

    if global_batch % jax.device_count():
        raise ValueError(
            f"global batch {global_batch} must divide the "
            f"{jax.device_count()}-device mesh (pad first — "
            "parallel.mesh.pad_to_multiple)")
    per_dev = global_batch // jax.device_count()
    # positions within the GLOBAL device list (what the mesh/sharding
    # orders by) — raw device ids are NOT contiguous across processes
    # (measured: process 1's CPU devices start at id 2048)
    pos = {d.id: i for i, d in enumerate(jax.devices())}
    locs = sorted(pos[d.id] for d in jax.local_devices())
    if locs != list(range(locs[0], locs[0] + len(locs))):
        raise RuntimeError(
            f"local devices not contiguous in the global list: {locs}")
    return slice(locs[0] * per_dev, (locs[0] + len(locs)) * per_dev)


def global_array_from_local(mesh, local_rows: np.ndarray,
                            global_batch: int):
    """Assemble the globally-sharded batch from this process's rows —
    no process ever holds the global batch in host memory."""
    import jax

    sharding = batch_sharding(mesh, local_rows.ndim)
    global_shape = (global_batch,) + local_rows.shape[1:]
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local_rows), global_shape)


def sharded_inverse_global(mesh, a_global, algorithm: str = "lu"):
    """Batched inversion of an already-global array over the global
    mesh.  GSPMD path (plain-XLA algorithms): on a real pod the Pallas
    entries would route per-slice through shard_map exactly as in
    ``parallel.sharded`` — the registry marking logic is shared."""
    import jax

    from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

    fn = get_inverse_algorithm(algorithm)
    sharding = batch_sharding(mesh, 3)
    return jax.jit(fn, in_shardings=sharding, out_shardings=sharding)(
        a_global)


def _selftest_main(argv=None) -> int:
    """Worker entry for the two-process structural test:

        python -m cuda_matrix_inversion_tpu.parallel.multihost \
            --coordinator localhost:PORT --num-processes 2 --process-id I

    Builds the global mesh, inverts a deterministic globally-sharded SPD
    batch, verifies the process's OWN shards against the host oracle,
    prints MULTIHOST_OK.
    """
    import argparse
    import os

    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--local-devices", type=int, default=4)
    args = p.parse_args(argv)

    # must precede any jax import side effects
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count="
        f"{args.local_devices}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    initialize(args.coordinator, args.num_processes, args.process_id)

    n_global = args.num_processes * args.local_devices
    assert jax.device_count() == n_global, (
        jax.device_count(), n_global)
    assert len(jax.local_devices()) == args.local_devices

    from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch

    mesh = global_batch_mesh()
    global_batch, n = 2 * n_global, 8
    # deterministic: every process generates the same global fixture and
    # slices out its own rows — stands in for per-host ingest
    a_full = make_spd_batch(global_batch, n,
                            np.random.default_rng(7)).astype(np.float32)
    sl = local_batch_slice(global_batch)
    a_g = global_array_from_local(mesh, a_full[sl], global_batch)
    inv = sharded_inverse_global(mesh, a_g, algorithm="lu")
    inv.block_until_ready()

    assert len(inv.sharding.device_set) == n_global, "not globally sharded"
    per_dev = global_batch // n_global
    checked = 0
    for shard in inv.addressable_shards:
        rows = slice(shard.index[0].start, shard.index[0].stop)
        assert shard.data.shape[0] == per_dev
        err = np.abs(a_full[rows].astype(np.float64)
                     @ np.asarray(shard.data, np.float64)
                     - np.eye(n)).max()
        assert err < 1e-4, f"shard {shard.index}: {err}"
        checked += shard.data.shape[0]
    assert checked == args.local_devices * per_dev
    print(f"MULTIHOST_OK process={args.process_id} "
          f"checked_rows={checked}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(_selftest_main())
