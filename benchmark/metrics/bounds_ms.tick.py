"""bounds_ms.tick: median over the window's ticks of the program's
``io.bounds`` span (``RFDataset.bnds_update``: io.reader's get_bounds, which
lists the edge subdirectories and opens their edge files, and
data_version), ms a tick."""

from drfbench import spans


def read(run):
    return spans.median_per_tick(run, lambda t: t.total_us("io.bounds") / 1e3)
