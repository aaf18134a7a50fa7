"""Prefetching host producer for the device copies.

The port's counterpart of pyspectrogram_tpu/io/ingest.py::PrefetchFeeder,
without device placement: one worker thread runs ``produce(i)`` (the HDF5
read and the plane packing) up to ``depth`` items ahead, and the consumer
thread issues the host-to-device copies on its own current stream. The
JAX feeder is not reused because its worker imports jax even with
``device_put=False`` (io/ingest.py:46), and this package never imports
jax.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator


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
