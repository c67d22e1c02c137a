"""What a cell draws from ``--seed`` besides the season: the share of the
grid's cells that one card of a four-card day runs, and the smooth seasonal
hyperparameter fields of the quicklook product (also the start of the
chained fit).

Every draw has the same size whatever the seed: the share keeps each cell
with one probability, and the fields keep their waves and amplitude around
their constants; only which cells and which phases change. The season
itself comes from the configuration's ``season_seed``, the same for every
run, so that a run's accuracy varies with what the seed draws and not with
a new truth field.
"""

from __future__ import annotations

import numpy as np

HYPER_NAMES = ("ell_x", "ell_y", "ell_t", "sf2", "sn2")


def streams(seed: int, n: int) -> list:
    """``n`` independent generators of ``seed`` (any whole number)."""
    return [np.random.default_rng(s) for s in np.random.SeedSequence(abs(int(seed))).spawn(n)]


def share_mask(shape: tuple, share: float, rng: np.random.Generator) -> np.ndarray:
    """True at the cells one card runs: each cell independently with
    probability ``share``, as ``bench.py`` drops prediction cells. No
    observation is dropped, so every neighbourhood stays whole."""
    return rng.random(shape) < share


def hyper_fields(x: np.ndarray, y: np.ndarray, constants: dict, log_amplitude: float,
                 waves, rng: np.random.Generator) -> dict:
    """Smooth positive (G, G) fields ``c * exp(a * s)`` around the constants,
    where ``s`` in [-1, 1] is the mean of plane waves of the given
    (direction in degrees, wavelength in km), each at a phase drawn from
    ``rng``: every seed gets the same waves, shifted."""
    out = {}
    for name in HYPER_NAMES:
        s = np.zeros_like(x, dtype=np.float64)
        for deg, km in waves:
            ang = np.deg2rad(deg)
            phase = rng.uniform(0.0, 2.0 * np.pi)
            s += np.cos(2.0 * np.pi * (x * np.cos(ang) + y * np.sin(ang)) / (km * 1e3) + phase)
        out[name] = float(constants[name]) * np.exp(log_amplitude * s / len(waves))
    return out
