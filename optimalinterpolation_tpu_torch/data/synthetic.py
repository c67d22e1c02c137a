"""Synthetic along-track observation generator (reference-format data).

The reference repository ships only its *outputs* (quicklook NetCDFs); the
input pickles (daily gridded per-satellite freeboards) are not distributed.
This module manufactures a statistically similar season so the full pipeline
runs end-to-end and benchmarks at the production scale:

  * a smooth "true" freeboard field (large-scale harmonics + AR(1) daily
    evolution) on the reference's 320x320, 25 km npstere-style grid
    (grid geometry: ``read_and_bin.py:32,48-49`` — bins over [0, 8e6]^2 m);
  * a circular sea-ice extent mask around the pole with a seasonal edge;
  * per-satellite synthetic ground tracks (random great-circle-ish sweeps
    rasterized onto the grid) with N(0, sigma_obs) measurement noise —
    mimicking the sparse along-track coverage that drives neighborhood sizes;
  * outputs written as reference-layout pickles + ``x_/y_*.npy`` so
    ``read_freeboard_season`` consumes them unchanged.

Copy of ``optimalinterpolation_tpu/data/synthetic.py``, kept
until the JAX package's ``__init__`` is lazy (importing any module of it
imports jax today).
"""

from __future__ import annotations

import os

import numpy as np

from optimalinterpolation_tpu_torch.io.pickles import save_pickle

__all__ = ["make_synthetic_season", "synthetic_truth"]

GRID_EXTENT_M = 8.0e6  # read_and_bin.py:48-49 binning range


def _grid_coords(grid_res_km: int):
    n = int(GRID_EXTENT_M / (grid_res_km * 1000))
    edges = np.linspace(0.0, GRID_EXTENT_M, n + 1)
    centers = edges[:-1]  # reference stores bin *edges* [:-1] as coords
    gx, gy = np.meshgrid(centers, centers, indexing="ij")
    return gx, gy


def synthetic_truth(gx, gy, n_days, rng, amp=0.12, base=0.15, ar=0.9):
    """Smooth spatio-temporal truth field, metres of radar freeboard."""
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


def _ice_mask(gx, gy, day, n_days):
    """Disk-shaped 'sea ice extent' with a slowly advancing edge."""
    cx, cy = GRID_EXTENT_M / 2, GRID_EXTENT_M / 2
    r = np.hypot(gx - cx, gy - cy)
    radius = 1.6e6 + 0.6e6 * (day / max(n_days - 1, 1))
    sic = np.clip(1.2 - r / radius, 0.0, 1.0)
    return sic


def _tracks(gx, gy, rng, n_tracks, width_cells=1):
    """Rasterize synthetic polar-orbit ground tracks onto the grid.

    Each track is a straight chord across the domain passing near the pole
    (satellite inclination ~ 88-92 deg equivalent), ``width_cells`` wide.
    """
    n = gx.shape[0]
    hit = np.zeros((n, n), dtype=bool)
    for _ in range(n_tracks):
        ang = rng.uniform(0, np.pi)
        offset = rng.normal(0, 0.25e6)  # distance of chord from pole
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


def make_synthetic_season(
    outdir: str,
    grid_res_km: int = 25,
    n_days: int = 20,
    season: str = "2018-2019",
    start_date: str = "20181201",
    satellites=("CS2_SAR", "CS2_SARIN", "S3A", "S3B"),
    tracks_per_day=(14, 4, 12, 12),
    noise_std: float = 0.1,
    seed: int = 0,
):
    """Write a reference-layout synthetic season; returns the truth fields."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    gx, gy = _grid_coords(grid_res_km)
    truth = synthetic_truth(gx, gy, n_days, rng)

    import datetime as _dt

    d0 = _dt.datetime.strptime(start_date, "%Y%m%d")
    dates = [(d0 + _dt.timedelta(days=i)).strftime("%Y%m%d") for i in range(n_days)]

    sie_dict = {}
    sat_dicts = {s: {} for s in satellites}
    for di, date in enumerate(dates):
        sic = _ice_mask(gx, gy, di, n_days)
        sie_dict[date] = sic
        ice = sic >= 0.15
        for si, sat in enumerate(satellites):
            cover = _tracks(gx, gy, rng, tracks_per_day[si]) & ice
            field = np.full(gx.shape, np.nan)
            field[cover] = truth[di][cover] + rng.normal(0, noise_std, size=int(cover.sum()))
            sat_dicts[sat][date] = field

    for sat in satellites:
        save_pickle(
            sat_dicts[sat],
            os.path.join(outdir, f"{sat}_dailyFB_{grid_res_km}km_{season}_season.pkl"),
        )
    save_pickle(
        sie_dict, os.path.join(outdir, f"SIE_masking_{grid_res_km}km_{season}_season.pkl")
    )
    np.save(os.path.join(outdir, f"x_{grid_res_km}km.npy"), gx)
    np.save(os.path.join(outdir, f"y_{grid_res_km}km.npy"), gy)
    # A synthetic stand-in for the CS2 FYI prior product (constant_fyi_prior
    # consumes it): truth minus a small bias, with the same (G, G, T) layout.
    np.save(
        os.path.join(outdir, f"CS2_FYI_synthetic_{grid_res_km}km.npy"),
        np.transpose(truth, (1, 2, 0)) - 0.02,
    )
    return truth, dates
