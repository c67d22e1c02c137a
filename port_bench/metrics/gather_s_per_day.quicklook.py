"""Seconds a day in the program's neighbour gather, from the benchmark's
host span around each call (``multiday.gather_neighborhoods``), in the
quicklook cells."""

from port_bench.core import readers


def read(run):
    return readers.span_seconds_per_day(run, "gather")
