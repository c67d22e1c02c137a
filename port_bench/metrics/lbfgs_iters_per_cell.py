"""L-BFGS iterations a cell: the ``iters_sum`` of every fit stage of the
window's days over their active cells."""

from port_bench.core import readers


def read(run):
    iters = sum(e["iters_sum"] for d in run.days for e in d.stats
                if e["stage"] in readers.FIT_STAGES)
    return iters / run.cells() if run.cells() else None
