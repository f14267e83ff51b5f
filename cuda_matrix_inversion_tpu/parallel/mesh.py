"""Device-mesh construction and batch-axis sharding.

The reference is single-GPU, single-process (SURVEY §2.3: the only
transport is PCIe memcpy).  Scale-out is new design here: the workload is
embarrassingly parallel per matrix, so the one axis that matters is the
batch axis, sharded over the devices of one host (BASELINE.json config 5:
10k × 128×128).  No collectives are required by the math — the
"communication backend" is pure sharding plus result gather, exactly as
SURVEY §5 prescribes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"


def batch_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the batch axis (the cards of one host are joined
    all to all, so the mesh follows the algorithm alone)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)} "
                f"({[d.platform for d in devices[:4]]}...)"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (BATCH_AXIS,))


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading (batch) dim, replicate the rest."""
    return NamedSharding(mesh, P(BATCH_AXIS, *([None] * (ndim - 1))))


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    """Pad the batch axis so it divides the mesh; returns (padded, orig_len).

    Sharding a 10k batch over 8 devices needs batch % 8 == 0; we pad with
    identity-safe copies of the last element (cheap, keeps SPD-ness).
    """
    size = arr.shape[axis]
    rem = size % multiple
    if rem == 0:
        return arr, size
    pad = multiple - rem
    pad_block = np.repeat(np.take(arr, [-1], axis=axis), pad, axis=axis)
    return np.concatenate([arr, pad_block], axis=axis), size
