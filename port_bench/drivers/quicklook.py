"""Quicklook days: one predict a day at the seasonal hyper fields
(``interpolate_days``'s ``precomputed_hypers``); nothing is fitted or
smoothed."""

FITS = False


def start(run) -> None:
    pass


def day(run, w):
    return run.day(w, precomputed_hypers=run.hyper_fields)
