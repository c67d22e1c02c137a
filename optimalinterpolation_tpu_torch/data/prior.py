"""Prior-mean models (reference component C9).

Two priors exist in the reference:
  * production: a constant scalar, the 9-day nanmean of a CryoSat-2
    first-year-ice freeboard product, rounded to 3 decimals
    (``GPR_CS2S3.py:210-212``);
  * dev notebook: a spatially varying background, the 31-day all-satellite
    mean with the pole hole (lat > 87N) filled by the mean of valid pole-hole
    cells (``dev/sparseGP_example.ipynb`` cell-1, ``background``/``priorXS``).

Copy of ``optimalinterpolation_tpu/data/prior.py``, kept because importing
any module of that package imports JAX.
"""

from __future__ import annotations

import numpy as np

__all__ = ["constant_fyi_prior", "background_prior"]


def constant_fyi_prior(fyi: np.ndarray, day: int, offset: int = 16, window: int = 9) -> float:
    """Scalar prior: round(nanmean(fyi[:, :, day+offset : day+offset+window]), 3).

    ``offset`` aligns the FYI product's start date with the observation start
    date (the reference's hardcoded ``day+16:day+25`` slice, GPR_CS2S3.py:212);
    use ``offset=0`` for products aligned to the season start (e.g. the
    synthetic season generator's FYI file).
    """
    sl = fyi[:, :, day + offset : day + offset + window]
    if sl.size == 0 or not np.isfinite(sl).any():
        raise ValueError(
            f"FYI prior slice [{day + offset}:{day + offset + window}] is empty "
            f"(product has {fyi.shape[2]} days); a NaN prior would silently NaN "
            f"every cell. Check the offset (reference product: 16; "
            f"season-aligned product: 0)."
        )
    return float(np.round(np.nanmean(sl), 3))


def background_prior(
    obs: np.ndarray,  # (G, G, S, T) full-season stacked observations
    lat: np.ndarray,  # (G, G) latitudes
    n_days: int = 31,
    pole_lat: float = 87.0,
) -> np.ndarray:
    """Spatially varying prior: first-``n_days`` all-satellite mean field with
    pole-hole fill (dev notebook semantics). NaN where never observed."""
    import warnings

    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        # all-NaN cells are expected (never-observed ocean) and map to NaN
        warnings.simplefilter("ignore", RuntimeWarning)
        background = np.nanmean(obs[:, :, :, :n_days], axis=(2, 3))
    hole = np.isnan(background) & (lat > pole_lat)
    valid_pole = (~np.isnan(background)) & (lat > pole_lat)
    if valid_pole.any():
        background = background.copy()
        background[hole] = np.mean(background[valid_pole])
    return background
