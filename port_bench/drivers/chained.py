"""Chained fit days, as ``season`` chains them: each day starts from the
fitted hyper fields of the window before it (``interpolate_days``'s
``init_hypers``), which ran one wave earlier (the day before's call at one
window a wave). The set-up's first wave starts every chain from the seeded
hyper fields."""

FITS = True


def start(run) -> None:
    run.state["chain"] = {}


def wave(run, ws):
    chain = run.state["chain"]
    days = run.wave(ws, init_hypers=[chain[w - 1] if chain else run.hyper_fields for w in ws])
    run.state["chain"] = {d.w: d.result.hypers for d in days}
    return days
