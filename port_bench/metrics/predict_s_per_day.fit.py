"""Seconds a day in the predict stages (``stats`` walls of ``predict``
and ``pass2``, each ending with its bucket's results on the host), in
the fit cells."""

from port_bench.core import readers


def read(run):
    return readers.stage_seconds_per_day(run, readers.PREDICT_STAGES)
