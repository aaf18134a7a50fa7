"""refresh_ms.tick: median over the window's ticks of the self time of the
program's ``live.refresh`` span (the ring's gather, B2's launch, the tile
and the tail view, less the tail's ``live.read``), ms a tick."""

from drfbench import spans


def read(run):
    return spans.median_per_tick(
        run, lambda t: t.self_us("live.refresh") / 1e3)
