"""Chained fit days: each day starts from the previous day's fitted hyper
fields (``interpolate_days``'s ``init_hypers``), as ``season`` chains them at
wave width 1. The chain starts in set-up from the seeded hyper fields, on
the day before the window's first."""

FITS = True


def start(run) -> None:
    run.state["chain"] = run.hyper_fields


def day(run, w):
    d = run.day(w, init_hypers=[run.state["chain"]])
    run.state["chain"] = d.result.hypers
    return d
