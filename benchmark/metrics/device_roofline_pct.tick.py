"""device_roofline_pct.tick: the least time of the ticks' device work
(new samples read, new columns written, the window read once by the
median, median and view written) over the kernels' time inside the
ticks, %."""

from drfbench.rundata import roofline_pct


def read(run):
    return roofline_pct(run, "tick", "bench.tick")
