"""Seconds a day in the smoothing of the five hyper fields (``stats``
wall of ``smooth``)."""

from port_bench.core import readers


def read(run):
    return readers.stage_seconds_per_day(run, ("smooth",))
