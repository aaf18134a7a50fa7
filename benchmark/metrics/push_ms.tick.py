"""push_ms.tick: median over the window's ticks of the self time of the
program's ``live.push`` span (``LiveStreamEngine._push_new`` less its
``live.read`` children: the pinned copy, the copy to the device and B3's
launch), ms a tick."""

from drfbench import spans


def read(run):
    return spans.median_per_tick(run, lambda t: t.self_us("live.push") / 1e3)
