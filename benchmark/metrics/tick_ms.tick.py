"""tick_ms.tick: median over the window's ticks (of every tab) of the
live tick's wall time, from the iteration's bounds refresh to its result
in the tab's callback (runtime.processor -> runtime.live ->
models.streaming), ms a tick."""

from drfbench.rundata import percentile_ms


def read(run):
    return percentile_ms(run.latencies.get("tick"), 50)
