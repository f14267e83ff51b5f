"""Streaming batch loader: overlap host ingest with device compute.

Reference counterpart: the pinned-memory transfer machinery measured in
``src/bench.cu:112-156`` and the pitched batched uploads
(``inverse_cholesky_gpu.cu:204-215``) — the reference's answer to feeding
the device.  The answer here is a prefetching pipeline: a
background thread parses ``.mats`` shards (native C++ parser when built)
and issues ``jax.device_put`` while the device crunches the previous
batch; ``device_put`` is async, so transfer N+1 overlaps compute N and
the consumer only ever blocks on data that is already in flight.

Usage::

    for batch in DeviceBatchStream(paths, batch_size=256):
        out = jitted_fn(batch)   # batch is already device-resident
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np


class DeviceBatchStream:
    """Iterate device-resident batches with background prefetch.

    ``source``: either an iterable of host ndarrays, or a sequence of
    ``.mats`` file paths (each file yields its matrices).  ``batch_size``
    re-chunks the stream; ``prefetch`` bounds the number of in-flight
    device batches (the double-buffer depth — 2 is the pinned
    ping-pong analog).
    """

    _END = object()

    def __init__(
        self,
        source: Iterable,
        batch_size: Optional[int] = None,
        prefetch: int = 2,
        device=None,
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        sharding=None,
    ):
        self.source = source
        self.batch_size = batch_size
        self.prefetch = max(1, prefetch)
        self.device = device
        self.transform = transform
        self.sharding = sharding
        self._error: Optional[BaseException] = None

    # -- host-side ingest ------------------------------------------------
    def _host_arrays(self) -> Iterator[np.ndarray]:
        from cuda_matrix_inversion_tpu.io.mats import read_mats

        for item in self.source:
            if isinstance(item, (str, bytes)):
                arr = read_mats(item)
            else:
                arr = np.asarray(item)
            if arr.ndim == 2:
                arr = arr[None]
            yield arr

    def _host_batches(self) -> Iterator[np.ndarray]:
        if self.batch_size is None:
            yield from self._host_arrays()
            return
        buf = []
        have = 0
        for arr in self._host_arrays():
            buf.append(arr)
            have += arr.shape[0]
            while have >= self.batch_size:
                cat = np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
                yield cat[: self.batch_size]
                rest = cat[self.batch_size:]
                buf = [rest] if rest.shape[0] else []
                have = rest.shape[0]
        if have:
            yield np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]

    # -- device-side prefetch ---------------------------------------------
    def __iter__(self):
        import jax

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that notices consumer abandonment: a plain
            # q.put would block forever (leaking the thread + prefetched
            # HBM batches) if the caller breaks out of the loop early
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for host in self._host_batches():
                    if stop.is_set():
                        return
                    if self.transform is not None:
                        host = self.transform(host)
                    # async: returns immediately, transfer proceeds in
                    # the background while the consumer computes
                    target = self.sharding if self.sharding is not None else self.device
                    if not put(jax.device_put(host, target)):
                        return
            except BaseException as exc:  # surfaced on the consumer side
                self._error = exc
            finally:
                put(self._END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._END:
                    if self._error is not None:
                        raise self._error
                    return
                yield item
        finally:
            stop.set()  # GeneratorExit / break: release the producer


def stream_inverse(
    paths: Sequence[str],
    algorithm: str = "newton_schulz",
    batch_size: int = 256,
    device=None,
):
    """End-to-end streamed inversion: parse → prefetch → invert, with
    ingest overlapped against device compute.  Yields host ndarrays."""
    import jax

    from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

    fn = None
    for batch in DeviceBatchStream(paths, batch_size=batch_size, device=device):
        if fn is None:
            fn = jax.jit(get_inverse_algorithm(algorithm))
        yield np.asarray(jax.device_get(fn(batch)))
