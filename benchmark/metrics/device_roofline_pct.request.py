"""device_roofline_pct.request: the least time of the requests' device
work (the block read once, spectra and median written once, at the HBM
rate; or their float32 operations) over the kernels' time inside the
device half's spans, %."""

from drfbench.rundata import roofline_pct


def read(run):
    return roofline_pct(run, "request", "bench.compute_block")
