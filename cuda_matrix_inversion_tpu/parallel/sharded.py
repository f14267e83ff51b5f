"""Sharded batched ops: inversion, the GP pipeline and its fit over a
device mesh.

New capability vs the single-GPU reference (SURVEY §2.3 row
"multi-chip scale-out").  Two dispatch strategies:

* **GSPMD** (``NamedSharding`` annotation + jit): XLA partitions the
  program.  Correct for plain-XLA algorithms (LU/Cholesky, jnp
  Newton–Schulz) — the math has no cross-matrix dependence, so the
  partitioner splits the batch communication-free.
* **shard_map**: the single-device function runs verbatim on each
  device's batch shard.  This is MANDATORY for Pallas-backed algorithms:
  ``pallas_call`` lowers to a custom call, which the GSPMD partitioner
  cannot split — on a multi-device mesh it would replicate the whole
  batch per device or fail to partition.  (On the CPU test mesh the
  kernels run in interpret mode where they are plain HLO, which is why
  the GSPMD path *appears* to work there.)

``sharded_inverse`` picks the strategy from the registry's Pallas
marking; the explicit ``*_shard_map`` wrappers force per-shard execution.

Batches that don't divide the mesh are padded (identity matrices for
inversion, inert zero-vector problems for GP) and un-sliced after —
shard_map requires the global batch to split evenly.
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cuda_matrix_inversion_tpu.parallel.mesh import BATCH_AXIS, batch_sharding


def _shard(mesh, x):
    return jax.device_put(x, batch_sharding(mesh, jnp.ndim(x)))


def _pad_batch_to_mesh(mesh, arrays, fills):
    """Pad every array's batch axis with inert entries so it divides the
    mesh (shard_map needs even shards); returns (padded_tuple, orig_size).

    ``fills[i]`` is a callable ``(pad, array) -> pad_block`` choosing the
    inert content per operand (identity matrices, zero/one vectors, ...).
    The single home for the size/remainder edge cases that were once
    copy-pasted per entry point (code-review r3).
    """
    size = int(mesh.devices.size)
    arrays = tuple(jnp.asarray(a) for a in arrays)
    batch = arrays[0].shape[0]
    rem = batch % size
    if rem == 0 and batch > 0:
        return arrays, batch
    pad = size - rem if batch > 0 else size
    return tuple(jnp.concatenate([a, fill(pad, a)], axis=0)
                 for a, fill in zip(arrays, fills)), batch


def _fill_eye(pad, a):
    n = a.shape[-1]
    return jnp.broadcast_to(jnp.eye(n, dtype=a.dtype), (pad, n, n))


def _fill_zeros(pad, a):
    return jnp.zeros((pad,) + a.shape[1:], a.dtype)


def _fill_ones(pad, a):
    return jnp.ones((pad,) + a.shape[1:], a.dtype)


def _pad_to_mesh(mesh, a):
    """Pad the batch axis with identity matrices so it divides the mesh."""
    (padded,), batch = _pad_batch_to_mesh(mesh, (a,), (_fill_eye,))
    return padded, batch


@partial(jax.jit, static_argnames=("algorithm",))
def _inverse_annotated(a, algorithm: str):
    from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

    return get_inverse_algorithm(algorithm)(a)


@functools.lru_cache(maxsize=64)
def _inverse_shard_mapped(mesh, algorithm: str):
    """One compiled shard_map closure per (mesh, algorithm) — building a
    fresh closure per call would recompile every time (CLAUDE.md gotcha)."""
    from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

    fn = get_inverse_algorithm(algorithm)
    spec = P(BATCH_AXIS, None, None)
    # check_vma=False: pallas_call outputs carry no varying-mesh-axes
    # annotation, and the per-shard math is batch-local anyway
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,),
                                 out_specs=spec, check_vma=False))


def sharded_inverse_shard_map(mesh, a, algorithm: str = "lu"):
    """Invert via shard_map: the single-device kernel runs verbatim on each
    device's shard (no partitioner in the loop).  Pads the batch to the mesh
    size when needed and slices the result back."""
    padded, batch = _pad_to_mesh(mesh, a)
    out = _inverse_shard_mapped(mesh, algorithm)(_shard(mesh, padded))
    return out if out.shape[0] == batch else out[:batch]


def sharded_inverse(mesh, a, algorithm: str = "lu"):
    """Invert a batch sharded over ``mesh``; returns a sharded device array.

    Input may be host (it will be scattered) or already sharded.  Pallas-
    backed algorithms route through shard_map (GSPMD cannot partition a
    Pallas custom call); plain-XLA algorithms go through the partitioner.
    """
    from cuda_matrix_inversion_tpu.ops.registry import is_pallas_algorithm

    if is_pallas_algorithm(algorithm):
        return sharded_inverse_shard_map(mesh, a, algorithm)
    a_sharded = _shard(mesh, a)
    return _inverse_annotated(a_sharded, algorithm)


@functools.lru_cache(maxsize=8)
def _warm_shard_mapped(mesh):
    from cuda_matrix_inversion_tpu.ops.newton_schulz import (
        inverse_newton_schulz_warm,
    )

    spec = P(BATCH_AXIS, None, None)
    return jax.jit(jax.shard_map(inverse_newton_schulz_warm, mesh=mesh,
                                 in_specs=(spec, spec), out_specs=spec,
                                 check_vma=False))


def sharded_inverse_warm(mesh, a, x0):
    """Warm-start Newton-Schulz refinement over the mesh — the serving
    path (refresh a slowly-varying batch from its previous inverse) runs
    per-shard via shard_map like every Pallas kernel.  Both operands are
    padded identically (identity pads refine to identity, staying inert)."""
    padded_a, batch = _pad_to_mesh(mesh, a)
    padded_x0, _ = _pad_to_mesh(mesh, x0)
    out = _warm_shard_mapped(mesh)(_shard(mesh, padded_a),
                                   _shard(mesh, padded_x0))
    return out if out.shape[0] == batch else out[:batch]


# ---- GP pipeline ----


@partial(jax.jit, static_argnames=("method",))
def _gp_annotated(a, b, c, d, e, method: str):
    from cuda_matrix_inversion_tpu.models.gp import gp_mean_variance

    return gp_mean_variance(a, b, c, d, e, method=method)


@functools.lru_cache(maxsize=64)
def _gp_shard_mapped(mesh, method: str):
    from cuda_matrix_inversion_tpu.models.gp import gp_mean_variance

    spec3 = P(BATCH_AXIS, None, None)
    fn = partial(gp_mean_variance, method=method)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(spec3,) * 5, out_specs=(spec3, spec3),
        check_vma=False,
    ))


def _pad_gp_to_mesh(mesh, a, b, c, d, e):
    """Pad GP operands with inert problems (identity B, zero vectors) so
    the batch divides the mesh."""
    return _pad_batch_to_mesh(
        mesh, (a, b, c, d, e),
        (_fill_zeros, _fill_eye, _fill_zeros, _fill_zeros, _fill_zeros))


def sharded_gp_shard_map(mesh, a, b, c, d, e, method: str = "solve"):
    """GP pipeline via shard_map — per-shard verbatim execution."""
    (a, b, c, d, e), batch = _pad_gp_to_mesh(mesh, a, b, c, d, e)
    args = [_shard(mesh, x) for x in (a, b, c, d, e)]
    mean, var = _gp_shard_mapped(mesh, method)(*args)
    if mean.shape[0] != batch:
        mean, var = mean[:batch], var[:batch]
    return mean, var


def sharded_gp_mean_variance(mesh, a, b, c, d, e, method: str = "solve"):
    """The full GP pipeline with every operand sharded on the batch axis,
    partitioned by GSPMD."""
    args = [_shard(mesh, x) for x in (a, b, c, d, e)]
    return _gp_annotated(*args, method=method)


# ---- GP hyper-parameter fit ----

def sharded_fit_gp_scales(mesh, b, c, d, steps: int = 150, lr: float = 0.05):
    """Hyper-parameter fit over the mesh (``models/gp_fit.py``), batch
    sharded and partitioned by GSPMD; each system's Adam trajectory is
    independent, so no collectives beyond the convergence trace's mean.

    A batch that does not divide the mesh is padded with inert systems
    (identity B, unit noise, zero observations) of loss weight 0: their θ
    stays at the start and they drop out of ``lml_path``.  Returns a
    ``GPFitResult`` with sharded per-system leaves.
    """
    from cuda_matrix_inversion_tpu.models.gp_fit import (
        GPFitResult,
        fit_gp_scales,
    )

    w = jnp.ones((jnp.asarray(b).shape[0],), jnp.asarray(b).dtype)
    (b, c, d, w), batch = _pad_batch_to_mesh(
        mesh, (b, c, d, w), (_fill_eye, _fill_ones, _fill_zeros,
                             _fill_zeros))
    res = fit_gp_scales(*(_shard(mesh, x) for x in (b, c, d)), steps=steps,
                        lr=lr, weights=_shard(mesh, w))
    if res.log_amp.shape[0] == batch:
        return res
    return GPFitResult(log_amp=res.log_amp[:batch],
                       log_noise=res.log_noise[:batch],
                       lml=res.lml[:batch], lml_path=res.lml_path)
