"""device_idle_tick_pct.tick: the device's idle time (the window less the
union of its events) inside the program's ``processor.tick`` spans (host
work inside a tick), over the window, %."""

from drfbench import spans


def read(run):
    return spans.idle_pct_inside(run, "processor.tick")
