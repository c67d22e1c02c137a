"""Freeboard dataset assembly (reference layer L1).

Rebuilds ``readFB`` (``GPR_CS2S3.py:
25-63``): load the four per-satellite daily-gridded-freeboard pickles plus the
sea-ice-extent pickle, keep only dates present for all satellites, stack to
``obs[x, y, sat, t]`` / ``sie[x, y, t]``, and mask SIE < 0.15 to NaN.

File layout and pickle schema are byte-compatible with the reference
(``{SAT}_dailyFB_{res}km_{season}_season.pkl`` holding ``{yyyymmdd: (G, G)
float array}``), so data produced for the reference drops straight in.

Copy of ``optimalinterpolation_tpu/data/reader.py``, kept
until the JAX package's ``__init__`` is lazy (importing any module of it
imports jax today).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

from optimalinterpolation_tpu_torch.io.pickles import load_pickle

DEFAULT_SATELLITES = ("CS2_SAR", "CS2_SARIN", "S3A", "S3B")
SIE_THRESHOLD = 0.15  # GPR_CS2S3.py:62


@dataclasses.dataclass
class ObsDataset:
    """Stacked multi-satellite gridded observations for one season."""

    obs: np.ndarray  # (G, G, S, T) daily gridded freeboard, NaN = no data
    sie: np.ndarray  # (G, G, T) sea-ice extent, NaN where < threshold
    dates: list  # length-T list of 'yyyymmdd' strings
    x: np.ndarray  # (G, G) projected x cell coordinates [m]
    y: np.ndarray  # (G, G) projected y cell coordinates [m]
    grid_res_km: int = 25
    satellites: Sequence[str] = DEFAULT_SATELLITES

    @property
    def grid_shape(self):
        return self.obs.shape[:2]

    @property
    def n_days(self):
        return self.obs.shape[3]


def read_freeboard_season(
    datapath: str,
    grid_res: int,
    season: str,
    satellites: Sequence[str] = DEFAULT_SATELLITES,
    sie_threshold: float = SIE_THRESHOLD,
) -> ObsDataset:
    """Load a season of daily gridded freeboards in the reference layout."""
    sat_dicts = [
        load_pickle(
            os.path.join(
                datapath, f"{sat}_dailyFB_{grid_res}km_{season}_season.pkl"
            )
        )
        for sat in satellites
    ]
    sie_dict = load_pickle(
        os.path.join(datapath, f"SIE_masking_{grid_res}km_{season}_season.pkl")
    )

    # Dates present for every satellite, sorted (GPR_CS2S3.py:50-59).
    dates = sorted(k for k in sat_dicts[0] if all(k in d for d in sat_dicts[1:]))
    obs = np.stack(
        [np.stack([d[k] for d in sat_dicts], axis=0) for k in dates], axis=0
    )  # (T, S, G, G)
    obs = obs.transpose(2, 3, 1, 0)  # (G, G, S, T)
    sie = np.stack([sie_dict[k] for k in dates], axis=0).transpose(1, 2, 0)
    sie = np.where(sie < sie_threshold, np.nan, sie)

    x = np.load(os.path.join(datapath, f"x_{grid_res}km.npy"))
    y = np.load(os.path.join(datapath, f"y_{grid_res}km.npy"))
    return ObsDataset(
        obs=obs, sie=sie, dates=list(dates), x=x, y=y,
        grid_res_km=grid_res, satellites=tuple(satellites),
    )
