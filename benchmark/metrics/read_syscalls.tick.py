"""read_syscalls.tick: median over the window's ticks of the ``syscalls``
the program counts in its ``live.read`` spans (io.fastread's stat, open,
preadv and close, and the system calls of the HDF5 files io.hdf5 opens
for the read), calls a tick."""

from drfbench import spans


def read(run):
    return spans.median_per_tick(
        run, lambda t: t.counted("live.read", "syscalls"))
