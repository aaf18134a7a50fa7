"""device_idle_wait_pct.tick: the device's idle time (the window less the
union of its events) inside the program's ``processor.wait`` spans (a
tab's pacing between ticks), over the window, %."""

from drfbench import spans


def read(run):
    return spans.idle_pct_inside(run, "processor.wait")
