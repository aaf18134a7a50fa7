"""readback_ms.tick: median over the window's ticks of the program's
``live.readback`` span (the view's and the median's copies to the host:
the host waiting for the device), ms a tick."""

from drfbench import spans


def read(run):
    return spans.median_per_tick(
        run, lambda t: t.total_us("live.readback") / 1e3)
