"""read_ms.tick: median over the window's ticks of the program's
``live.read`` spans summed per tick (every read of a tick: the push's
blocks, a carry seed, the tail; runtime.live -> io.reader -> io.fastread),
ms a tick."""

from drfbench import spans


def read(run):
    return spans.median_per_tick(run, lambda t: t.total_us("live.read") / 1e3)
