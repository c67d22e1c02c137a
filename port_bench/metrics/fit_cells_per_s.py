"""Active cells of the two-pass days completed in the window over the
window's seconds (host clock): all the work over all the time."""

from port_bench.core import readers


def read(run):
    return readers.cells_per_s(run)
