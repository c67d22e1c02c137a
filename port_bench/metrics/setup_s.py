"""Seconds from the process's start to the window's start (host clock):
imports, the card's context, the kernels' build where there is none, the
season, and the warm day."""


def read(run):
    return run.setup_s
