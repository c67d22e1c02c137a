"""Active cells of the predict-only days completed in the window over the
window's seconds (host clock)."""

from port_bench.core import readers


def read(run):
    return readers.cells_per_s(run)
