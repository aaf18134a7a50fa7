"""Faults planted under the timed path, to show that the check of a run
fails them: used by ``tools/readings.py`` (on the card) and the tests
(on the CPU), never by a benchmark run.

Each fault patches the program in this process for the length of a
``with plant(kind, name):`` block:

* ``stale``: a step returns its state unchanged (a live tick: nothing
  pushed, from the window's start; a view holds no state);
* ``half_batch``: half of the batch left out (a view's median over half
  its columns; a tick's median over half the window);
* ``altered``: an answer altered where it is produced (one spectrum bin
  of a view +1 dB; one tile pixel of a tick +8 levels).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

NAMES = ("stale", "half_batch", "altered")


@contextlib.contextmanager
def _patched(obj, attr: str, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


@contextlib.contextmanager
def plant(kind: str, name: str):
    from drfbench import spec

    driver = spec.traffic_driver(kind)
    if name not in driver.FAULTS:
        raise ValueError(f"a {kind} cell has no fault {name!r}")
    with driver.fault(name):
        yield


def browse(name: str):
    from pyspectrogram_tpu_torch.models.sti import StiPipeline

    compute = StiPipeline.compute

    def faulty(self, *a, **kw):
        res = compute(self, *a, **kw)
        if name == "half_batch":
            db = res.sxx_dbfs[:, : res.sxx_dbfs.shape[1] // 2]
            return dataclasses.replace(
                res, sxx_med_dbfs=np.median(db, axis=1).astype(np.float32))
        db = res.sxx_dbfs.copy()
        db[len(db) // 3, 0, 0] += 1.0
        return dataclasses.replace(res, sxx_dbfs=db)

    return _patched(StiPipeline, "compute", faulty)


@contextlib.contextmanager
def live(name: str):
    from drfbench.live import Live
    from pyspectrogram_tpu_torch.models.streaming import StreamingSti
    from pyspectrogram_tpu_torch.runtime.live import LiveStreamEngine

    if name == "stale":
        push = LiveStreamEngine._push_new
        armed = []

        def stale_push(self):
            return 0 if armed else push(self)

        window = Live.window

        def armed_window(self, *a, **kw):
            armed.append(True)
            return window(self, *a, **kw)

        with _patched(LiveStreamEngine, "_push_new", stale_push), \
                _patched(Live, "window", armed_window):
            yield
    elif name == "half_batch":
        refresh = StreamingSti.refresh_local

        def half(self, *a, **kw):
            kw["n_med"] = max(1, int(kw["n_med"]) // 2)
            return refresh(self, *a, **kw)

        with _patched(StreamingSti, "refresh_local", half):
            yield
    else:
        tick = LiveStreamEngine.tick

        def altered(self, cfg):
            res = tick(self, cfg)
            if res is not None and res.tile is not None:
                t = res.tile
                t[len(t) // 2, 0, t.shape[-1] // 3] = (
                    int(t[len(t) // 2, 0, t.shape[-1] // 3]) + 8) % 256
            return res

        with _patched(LiveStreamEngine, "tick", altered):
            yield
