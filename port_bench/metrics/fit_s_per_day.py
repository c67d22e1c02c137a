"""Seconds a day in the fit stages (``stats`` walls of ``seed:*``,
``cascade`` and ``opt``), which end in a host sync."""

from port_bench.core import readers


def read(run):
    return readers.stage_seconds_per_day(run, readers.FIT_STAGES)
