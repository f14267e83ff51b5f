"""Mixed-dimension size-bucketed batching — one fused dispatch.

Reference counterpart: a *designed but never implemented* feature — the
README proposes bucketing varying-size sensor matrices into max-size
queues {32,128,512,1024} with one CUDA stream per bucket
(``README.md:41-44``, SURVEY §2.3 / §5).  The realization here:

* each matrix goes to the smallest bucket ≥ its dimension and is padded
  with an identity block — the inverse of ``blockdiag(A, I)`` is
  ``blockdiag(A⁻¹, I)``, so un-padding is an exact slice, and the GP
  pipeline pads a,c,d with zeros so the padded rows contribute nothing;
* all buckets are processed by ONE jitted function (a dict of stacked
  bucket arrays in, a dict out) → one XLA executable, one dispatch —
  the analog of concurrent streams is XLA's own intra-executable
  scheduling, with zero host round-trips between buckets.

Bucket shapes are static per combination; a new combination of occupied
buckets compiles once and is cached by jit.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_BUCKETS = (8, 32, 128, 512)


def assign_buckets(
    sizes: Sequence[int], buckets: Sequence[int] = DEFAULT_BUCKETS
) -> List[int]:
    """Smallest bucket ≥ n for each size (ref README.md:41-44 design)."""
    out = []
    for n in sizes:
        for b in buckets:
            if n <= b:
                out.append(b)
                break
        else:
            raise ValueError(f"matrix dim {n} exceeds largest bucket {buckets[-1]}")
    return out


def pack_buckets(
    matrices: Sequence[np.ndarray], buckets: Sequence[int] = DEFAULT_BUCKETS
) -> Tuple[Dict[int, np.ndarray], List[Tuple[int, int, int]]]:
    """Pack ragged square matrices into per-bucket stacks.

    Returns ``(stacks, index)`` where ``stacks[b]`` is ``(k_b, b, b)`` and
    ``index[i] = (bucket, position, original_n)`` for matrix ``i``.
    Padding is an identity block (keeps every matrix invertible and the
    un-padded block of the inverse exact).
    """
    assignment = assign_buckets([m.shape[-1] for m in matrices], buckets)
    stacks: Dict[int, list] = {}
    index: List[Tuple[int, int, int]] = []
    for m, b in zip(matrices, assignment):
        n = m.shape[-1]
        if m.shape != (n, n):
            raise ValueError(f"square matrices required; got {m.shape}")
        padded = np.eye(b, dtype=m.dtype)
        padded = padded.copy()
        padded[:n, :n] = m
        pos = len(stacks.setdefault(b, []))
        stacks[b].append(padded)
        index.append((b, pos, n))
    return {b: np.stack(v) for b, v in stacks.items()}, index


@functools.partial(jax.jit, static_argnames=("algorithm", "keys"))
def _invert_buckets(stacks_tuple, algorithm: str, keys: Tuple[int, ...]):
    """One jitted dispatch inverting every bucket (single XLA executable)."""
    from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

    fn = get_inverse_algorithm(algorithm)
    return tuple(fn(s) for s in stacks_tuple)


def bucketed_inverse(
    matrices: Sequence[np.ndarray],
    algorithm: str = "cholesky",
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    mesh=None,
) -> List[np.ndarray]:
    """Invert a ragged list of square matrices in one fused dispatch.

    This is BASELINE.json config 4 ("mixed-dimension size-bucketed
    queues (8/32/128/512) in one fused dispatch").

    ``mesh``: optional ``jax.sharding.Mesh`` — each bucket's stack is then
    sharded over the batch axis (Pallas algorithms per-shard via
    shard_map, see :mod:`.sharded`); buckets still dispatch back-to-back
    without host synchronization between them.
    """
    stacks, index = pack_buckets(matrices, buckets)
    keys = tuple(sorted(stacks))
    if mesh is not None:
        from cuda_matrix_inversion_tpu.parallel.sharded import sharded_inverse

        outs = tuple(
            sharded_inverse(mesh, jnp.asarray(stacks[k]), algorithm)
            for k in keys
        )
    else:
        outs = _invert_buckets(tuple(jnp.asarray(stacks[k]) for k in keys),
                               algorithm, keys)
    by_bucket = dict(zip(keys, outs))
    results = []
    for b, pos, n in index:
        results.append(np.asarray(by_bucket[b][pos])[:n, :n])
    return results


@functools.partial(jax.jit, static_argnames=("method", "keys"))
def _gp_buckets(args_tuple, method: str, keys: Tuple[int, ...]):
    from cuda_matrix_inversion_tpu.models.gp import gp_mean_variance

    return tuple(gp_mean_variance(*args, method=method) for args in args_tuple)


def bucketed_gp_mean_variance(
    problems: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    method: str = "solve",
    buckets: Sequence[int] = DEFAULT_BUCKETS,
) -> List[Tuple[float, float]]:
    """Ragged GP mean/variance: each problem is (a, b, c, d, e) with its
    own n; zero-padded vectors make padded rows inert; one dispatch."""
    sizes = [p[1].shape[-1] for p in problems]
    assignment = assign_buckets(sizes, buckets)
    grouped: Dict[int, list] = {}
    index: List[Tuple[int, int]] = []
    for prob, bkt in zip(problems, assignment):
        a, b, c, d, e = (np.asarray(x) for x in prob)
        n = b.shape[-1]
        bp = np.eye(bkt, dtype=b.dtype)
        bp[:n, :n] = b
        pad_vec = lambda v: np.pad(v.reshape(n, 1), ((0, bkt - n), (0, 0)))  # noqa: E731
        entry = (pad_vec(a), bp, pad_vec(c), pad_vec(d), e.reshape(1, 1))
        pos = len(grouped.setdefault(bkt, []))
        grouped[bkt].append(entry)
        index.append((bkt, pos))

    keys = tuple(sorted(grouped))
    args_tuple = tuple(
        tuple(jnp.asarray(np.stack([ent[j] for ent in grouped[k]])) for j in range(5))
        for k in keys
    )
    outs = _gp_buckets(args_tuple, method, keys)
    by_bucket = dict(zip(keys, outs))
    results = []
    for bkt, pos in index:
        mean, var = by_bucket[bkt]
        results.append((float(np.asarray(mean)[pos, 0, 0]),
                        float(np.asarray(var)[pos, 0, 0])))
    return results
