"""The benchmark's synthetic season: a frozen, numpy-only copy of the port's
generator (``optimalinterpolation_tpu_torch/data/synthetic.py``).

The program's copy belongs to the program and may change; this one is the
yardstick and does not. For one seed it writes the same reference-layout
files as the port's ``make_synthetic_season`` (``tests/test_portbench_datagen.py``
holds the two equal): a smooth "true" freeboard field with AR(1) daily
evolution on the reference's polar grid, a disk-shaped sea-ice extent with an
advancing edge, and per-satellite straight ground tracks with N(0, noise)
measurement noise, as ``{SAT}_dailyFB_{res}km_{season}_season.pkl``,
``SIE_masking_{res}km_{season}_season.pkl`` and ``x_/y_{res}km.npy``. The
FYI prior product is not written: the benchmark's prior is a constant.

It returns the arrays too, so that the reference never reads what the
program read through the program's reader.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle

import numpy as np

GRID_EXTENT_M = 8.0e6
SEASON = "2018-2019"
START_DATE = "20181201"
SATELLITES = ("CS2_SAR", "CS2_SARIN", "S3A", "S3B")
SIE_THRESHOLD = 0.15


@dataclasses.dataclass
class Season:
    """The season as made: ``obs`` (G, G, S, T) with NaN where no track
    passed, ``sic`` (G, G, T) ice concentration, the grid coordinates and
    the truth (T, G, G) in metres."""

    obs: np.ndarray
    sic: np.ndarray
    x: np.ndarray
    y: np.ndarray
    truth: np.ndarray
    dates: list
    grid_res_km: int


def grid_coords(grid_res_km: int):
    n = int(GRID_EXTENT_M / (grid_res_km * 1000))
    edges = np.linspace(0.0, GRID_EXTENT_M, n + 1)
    centers = edges[:-1]
    return np.meshgrid(centers, centers, indexing="ij")


def _truth(gx, gy, n_days, rng, amp=0.12, base=0.15, ar=0.9):
    cx, cy = GRID_EXTENT_M / 2, GRID_EXTENT_M / 2
    r = np.hypot(gx - cx, gy - cy)
    theta = np.arctan2(gy - cy, gx - cx)
    spatial = (
        base
        + amp * np.cos(3 * theta) * np.exp(-r / 2.5e6)
        + amp * 0.6 * np.sin(2 * np.pi * gx / 3.1e6)
        + amp * 0.4 * np.cos(2 * np.pi * gy / 2.3e6)
    )
    fields = np.empty((n_days,) + gx.shape)
    innov = rng.normal(0, amp * 0.2, size=(n_days, 6))
    phase = np.zeros(6)
    for d in range(n_days):
        phase = ar * phase + innov[d]
        wobble = (
            phase[0] * np.sin(2 * np.pi * gx / 4.0e6)
            + phase[1] * np.cos(2 * np.pi * gy / 3.3e6)
            + phase[2] * np.sin(2 * np.pi * (gx + gy) / 5.1e6)
            + phase[3] * np.cos(3 * theta)
            + phase[4] * np.sin(2 * theta)
            + phase[5] * np.exp(-r / 2.0e6)
        )
        fields[d] = spatial + 0.25 * wobble
    return fields


def _ice_concentration(gx, gy, day, n_days):
    cx, cy = GRID_EXTENT_M / 2, GRID_EXTENT_M / 2
    r = np.hypot(gx - cx, gy - cy)
    radius = 1.6e6 + 0.6e6 * (day / max(n_days - 1, 1))
    return np.clip(1.2 - r / radius, 0.0, 1.0)


def _tracks(gx, rng, n_tracks, width_cells=1):
    n = gx.shape[0]
    hit = np.zeros((n, n), dtype=bool)
    for _ in range(n_tracks):
        ang = rng.uniform(0, np.pi)
        offset = rng.normal(0, 0.25e6)
        c, s = np.cos(ang), np.sin(ang)
        ts = np.linspace(-0.5 * GRID_EXTENT_M * 1.5, 0.5 * GRID_EXTENT_M * 1.5, 4 * n)
        px = GRID_EXTENT_M / 2 + ts * c - offset * s
        py = GRID_EXTENT_M / 2 + ts * s + offset * c
        res = GRID_EXTENT_M / n
        ix = np.floor(px / res).astype(int)
        iy = np.floor(py / res).astype(int)
        ok = (ix >= 0) & (ix < n) & (iy >= 0) & (iy < n)
        hit[ix[ok], iy[ok]] = True
        for dx in range(-width_cells + 1, width_cells):
            for dy in range(-width_cells + 1, width_cells):
                jx, jy = ix[ok] + dx, iy[ok] + dy
                okk = (jx >= 0) & (jx < n) & (jy >= 0) & (jy < n)
                hit[jx[okk], jy[okk]] = True
    return hit


def make_season(grid_res_km: int, n_days: int, tracks_per_day, noise_std: float,
                seed: int) -> Season:
    """The season's arrays, drawn from ``seed`` in the port's order."""
    rng = np.random.default_rng(seed)
    gx, gy = grid_coords(grid_res_km)
    truth = _truth(gx, gy, n_days, rng)
    d0 = datetime.datetime.strptime(START_DATE, "%Y%m%d")
    dates = [(d0 + datetime.timedelta(days=i)).strftime("%Y%m%d") for i in range(n_days)]
    obs = np.full(gx.shape + (len(SATELLITES), n_days), np.nan)
    sic = np.empty(gx.shape + (n_days,))
    for di in range(n_days):
        sic[:, :, di] = _ice_concentration(gx, gy, di, n_days)
        ice = sic[:, :, di] >= SIE_THRESHOLD
        for si in range(len(SATELLITES)):
            cover = _tracks(gx, rng, tracks_per_day[si]) & ice
            obs[:, :, si, di][cover] = truth[di][cover] + rng.normal(0, noise_std,
                                                                   size=int(cover.sum()))
    return Season(obs=obs, sic=sic, x=gx, y=gy, truth=truth, dates=dates,
                  grid_res_km=grid_res_km)


def _save_pickle(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=2)


def write_season(season: Season, outdir: str) -> None:
    """The reference-layout files of ``season`` under ``outdir``."""
    os.makedirs(outdir, exist_ok=True)
    res = season.grid_res_km
    for si, sat in enumerate(SATELLITES):
        _save_pickle({d: season.obs[:, :, si, di] for di, d in enumerate(season.dates)},
                     os.path.join(outdir, f"{sat}_dailyFB_{res}km_{SEASON}_season.pkl"))
    _save_pickle({d: season.sic[:, :, di] for di, d in enumerate(season.dates)},
                 os.path.join(outdir, f"SIE_masking_{res}km_{SEASON}_season.pkl"))
    np.save(os.path.join(outdir, f"x_{res}km.npy"), season.x)
    np.save(os.path.join(outdir, f"y_{res}km.npy"), season.y)
