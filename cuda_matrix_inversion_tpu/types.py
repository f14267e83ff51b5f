"""Scalar/dtype configuration and the batched-matrix container.

Reference counterpart: ``include/types.h:4-6`` — a single compile-time
``DataType`` switch (float) and ``Array`` (= ``float*``).  This build
upgrades it to a runtime-selectable default dtype (fp32/fp64/bf16 — the
fp32/fp64 sweep is a BASELINE.json config) and a shaped batch container
replacing raw pointers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

_DEFAULT_DTYPE = np.float32

_SUPPORTED = ("float32", "float64", "bfloat16")


def default_dtype() -> np.dtype:
    """The framework-wide default scalar dtype (reference: ``DataType``)."""
    return np.dtype(_DEFAULT_DTYPE)


def set_default_dtype(dtype) -> None:
    """Switch the default precision (analog of editing ``types.h:4``)."""
    global _DEFAULT_DTYPE
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name == "bfloat16":
        import jax.numpy as jnp

        _DEFAULT_DTYPE = jnp.bfloat16
        return
    if name not in _SUPPORTED:
        raise ValueError(f"unsupported dtype {name!r}; pick one of {_SUPPORTED}")
    if name == "float64":
        enable_x64()
    _DEFAULT_DTYPE = np.dtype(name)


def enable_x64() -> None:
    """Turn on JAX 64-bit mode (required for the fp64 sweep —
    BASELINE.json config 5)."""
    import jax

    jax.config.update("jax_enable_x64", True)


@dataclasses.dataclass
class MatrixBatch:
    """A host-side batch of equally-shaped matrices.

    Replaces the reference's contiguous column-major host block +
    pointer-array device layout (``src/helper.cu:15-52,103-118``).  Data is
    a C-contiguous ``(batch, m, n)`` ndarray; row ``i`` of matrix ``k`` is
    ``data[k, i, :]`` — the matrix *values* are identical to the reference's
    column-major blocks because ``.mats`` files store one matrix row per
    line (``tests/generate_*.m`` via ``dlmwrite``) and we parse rows as rows.
    """

    data: np.ndarray  # (batch, m, n)

    def __post_init__(self):
        arr = np.asarray(self.data)
        if arr.ndim == 2:  # a single matrix → batch of one
            arr = arr[None]
        if arr.ndim != 3:
            raise ValueError(f"MatrixBatch wants (batch, m, n); got {arr.shape}")
        self.data = np.ascontiguousarray(arr)

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]

    @property
    def m(self) -> int:
        return self.data.shape[1]

    @property
    def n(self) -> int:
        return self.data.shape[2]

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "MatrixBatch":
        return MatrixBatch(self.data.astype(dtype))

    def replicate(self, times: int) -> "MatrixBatch":
        """Duplicate the whole batch ``times``× (ref ``replicateMatrices``,
        ``src/helper.cu:54-72``)."""
        from cuda_matrix_inversion_tpu.io.replicate import replicate_matrices

        return MatrixBatch(replicate_matrices(self.data, times))

    def __getitem__(self, k) -> np.ndarray:
        return self.data[k]

    def __len__(self) -> int:
        return self.batch_size


def as_batch(x, dtype: Optional[np.dtype] = None) -> np.ndarray:
    """Coerce input to a C-contiguous (batch, m, n) ndarray."""
    if isinstance(x, MatrixBatch):
        x = x.data
    arr = np.asarray(x, dtype=dtype if dtype is not None else None)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim != 3:
        raise ValueError(f"expected (batch, m, n), got shape {arr.shape}")
    return np.ascontiguousarray(arr)
