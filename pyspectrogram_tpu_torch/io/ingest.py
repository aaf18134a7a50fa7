"""Prefetching host producers for the device copies — the port of
pyspectrogram_tpu/io/ingest.py.

:func:`prefetch` runs ``produce(i)`` (the HDF5 read and the plane
packing) on one worker thread up to ``depth`` items ahead; the request
path's consumer thread issues the host-to-device copies on its own
current stream. :class:`PrefetchFeeder` is the JAX module's feeder on it,
its ``device_put`` a copy of each item's arrays to the CUDA device. The
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
import torch


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


def _put(item, device: torch.device):
    """``item`` with every numpy array in it (the item itself, or a value
    of a tuple, list or dict in it) copied to ``device``
    (models.sti.to_device: pinned and non-blocking to a card)."""
    from pyspectrogram_tpu_torch.models.sti import to_device

    if isinstance(item, np.ndarray):
        return to_device(item, device)
    if isinstance(item, (tuple, list)):
        return type(item)(_put(a, device) for a in item)
    if isinstance(item, dict):
        return {k: _put(v, device) for k, v in item.items()}
    return item


class PrefetchFeeder:
    """The JAX module's feeder, on :func:`prefetch`: iterates
    ``produce(0) .. produce(n_blocks - 1)`` with up to ``depth`` of them
    produced ahead on a worker thread, a producer's exception raised at
    the consumer after the items before it; :meth:`close` (or leaving a
    ``with`` block) stops the worker.

    With ``device_put`` (as in JAX, a bool) the worker copies every numpy
    array of an item to this process's current CUDA device, so the copy
    overlaps the consumer's work; with False it yields the host arrays.
    """

    def __init__(self, produce: Callable[[int], object], n_blocks: int,
                 depth: int = 2, device_put: bool = True):
        self.produce = produce
        self.n_blocks = n_blocks
        self.device_put = device_put
        device = (torch.device("cuda", torch.cuda.current_device())
                  if device_put else None)

        def produce_put(i: int):
            item = produce(i)
            return item if device is None else _put(item, device)

        self._items = prefetch(produce_put, n_blocks, depth=depth)

    def __iter__(self) -> Iterator:
        return self._items

    def close(self) -> None:
        self._items.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def stream_blocks(ds, chan: str, start_sample: int, block_len: int,
                  n_blocks: int, depth: int = 2) -> PrefetchFeeder:
    """Prefetching feeder of plane-major host blocks from a dataset:
    yields (nsub*2, block_len) float32 (int16 for raw int16 captures)
    arrays, read and packed ``depth`` blocks ahead on a worker thread, for
    models.streaming.StreamingSti.push; the consumer copies each to its
    device (models.sti.to_device) on its own stream. The produce function
    is the JAX feeder's (io/ingest.py:94-117), on the port's own native
    ingest."""
    from pyspectrogram_tpu_torch.models.sti import _assemblable
    from pyspectrogram_tpu_torch.native import ingest as native_ingest

    def produce(i: int) -> np.ndarray:
        s = start_sample + i * block_len
        raw = _assemblable(ds.reader.read_vector_raw(s, block_len, chan))
        return native_ingest.assemble_plane_major(
            raw, np.asarray([0], np.int64), block_len)

    return PrefetchFeeder(produce, n_blocks, depth=depth, device_put=False)
