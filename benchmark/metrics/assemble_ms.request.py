"""assemble_ms.request: median over requests of the host read and
assembly (models.sti.assemble_device_block / _prefetch, which read
through io.reader, io.fastread and io.hdf5), ms a request."""

from drfbench.rundata import median_span_ms


def read(run):
    return median_span_ms(run, "assemble")
