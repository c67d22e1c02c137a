"""K3's share of its roofline, percent: the least time its launches'
work needs (``port_bench/kernels/k3.py``) over their device time by name in
the traced window."""

from port_bench.core import readers


def read(run):
    return readers.roofline(run, "k3")
