"""tick_read_ms.tick: median over ticks of the live engine's reads from
the growing files (runtime.live.LiveStreamEngine._read through
io.reader), ms a tick."""

from drfbench.rundata import median_span_ms


def read(run):
    return median_span_ms(run, "tick_read")
