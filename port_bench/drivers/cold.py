"""Cold fit days: every day fitted from the reference's x0 with no
``init_hypers``, so each runs the seed pass, the cascades and the fine
stage, as the ``daily`` command and a season's first wave do."""

FITS = True


def start(run) -> None:
    pass


def day(run, w):
    return run.day(w)
