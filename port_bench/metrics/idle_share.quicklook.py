"""Percent of the traced window in which nothing ran on the card: one
minus the union of the trace's device intervals over the window, in the quicklook
cells."""

from port_bench.core import readers


def read(run):
    return readers.idle_share(run)
