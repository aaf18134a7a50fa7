"""Prefetching host producer for the device copies.

The port's counterpart of pyspectrogram_tpu/io/ingest.py::PrefetchFeeder,
without device placement: one worker thread runs ``produce(i)`` (the HDF5
read and the plane packing) up to ``depth`` items ahead, and the consumer
thread issues the host-to-device copies on its own current stream. The
JAX feeder is not reused because its worker imports jax even with
``device_put=False`` (io/ingest.py:46), and this package never imports
jax. :func:`stream_blocks` is the port of the JAX module's block feeder
for the streaming push.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np


def prefetch(produce: Callable[[int], object], n_items: int,
             depth: int = 2) -> Iterator:
    """Yield ``produce(0) .. produce(n_items - 1)`` in order, with up to
    ``depth`` of them produced ahead on a worker thread. A producer's
    exception is raised at the item it failed on."""
    depth = max(1, depth)
    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = deque(ex.submit(produce, i)
                        for i in range(min(depth, n_items)))
        try:
            for i in range(n_items):
                item = pending.popleft().result()
                if i + depth < n_items:
                    pending.append(ex.submit(produce, i + depth))
                yield item
        finally:
            for f in pending:
                f.cancel()


def stream_blocks(ds, chan: str, start_sample: int, block_len: int,
                  n_blocks: int, depth: int = 2) -> Iterator[np.ndarray]:
    """Prefetching iterator of plane-major host blocks from a dataset:
    yields (nsub*2, block_len) float32 (int16 for raw int16 captures)
    arrays, read and packed ``depth`` blocks ahead on a worker thread, for
    models.streaming.StreamingSti.push; the consumer copies each to its
    device (models.sti.to_device). The produce function is the JAX
    feeder's (io/ingest.py:94-117), on the port's own native ingest."""
    from pyspectrogram_tpu_torch.models.sti import _assemblable
    from pyspectrogram_tpu_torch.native import ingest as native_ingest

    def produce(i: int) -> np.ndarray:
        s = start_sample + i * block_len
        raw = _assemblable(ds.reader.read_vector_raw(s, block_len, chan))
        return native_ingest.assemble_plane_major(
            raw, np.asarray([0], np.int64), block_len)

    return prefetch(produce, n_blocks, depth=depth)
