"""Host synchronisations a day of the lockstep L-BFGS
(``optimizer._lbfgs_segment.host_syncs``)."""

from port_bench.core import readers


def read(run):
    return readers.per_day(run, sum(d.host_syncs for d in run.days))
