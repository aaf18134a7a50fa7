"""compute_block_ms.request: median over requests of the device half
(StiPipeline.compute_block: the copy's end, B1, B2, dB and the readback),
ms a request."""

from drfbench.rundata import median_span_ms


def read(run):
    return median_span_ms(run, "compute_block")
