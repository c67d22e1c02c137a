"""Quicklook days: one predict a day at the seasonal hyper fields
(``interpolate_days``'s ``precomputed_hypers``); nothing is fitted or
smoothed. A wave of several windows is one combined predict."""

FITS = False


def start(run) -> None:
    pass


def wave(run, ws):
    return run.wave(ws, precomputed_hypers=run.hyper_fields)
