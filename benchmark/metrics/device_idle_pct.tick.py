"""The share of the traced window in which no kernel, copy or memset ran
on the device (the union of the device's events), %."""

from drfbench.rundata import idle_pct


def read(run):
    return idle_pct(run)
