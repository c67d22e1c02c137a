"""Prior-mean model of the production flow (reference component C9).

The production prior is a constant scalar: the 9-day nanmean of a CryoSat-2
first-year-ice freeboard product, rounded to 3 decimals
(``GPR_CS2S3.py:210-212``).

Copy of ``constant_fyi_prior`` from ``optimalinterpolation_tpu/data/prior.py``,
kept until the JAX package's ``__init__`` is lazy (importing any module of it
imports jax today).
"""

from __future__ import annotations

import numpy as np

__all__ = ["constant_fyi_prior"]


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
