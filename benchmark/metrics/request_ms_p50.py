"""request_ms_p50: the 50th percentile of the wall time of every
request in the window, from the call to the result on the host."""

from drfbench.rundata import percentile_ms


def read(run):
    return percentile_ms(run.latencies.get("request"), 50)
