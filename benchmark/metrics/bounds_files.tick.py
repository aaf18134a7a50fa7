"""bounds_files.tick: median over the window's ticks of the ``files`` the
program counts in its ``io.bounds`` span: the subdirectories and data
files io.reader lists plus the HDF5 files io.hdf5 opens, files a tick."""

from drfbench import spans


def read(run):
    return spans.median_per_tick(
        run, lambda t: t.counted("io.bounds", "files"))
