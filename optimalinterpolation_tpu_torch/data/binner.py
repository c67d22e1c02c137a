"""Along-track binner (reference component C1, layer L0).

Rebuilds ``read_and_bin`` (``read_and_bin.py:23-57``): parse raw ``.proc``
GPOD altimetry text files (columns: lon, lat, ..., freeboard at col 4, ...,
flag at col 7), keep valid returns (flag == 2, -0.37 <= fb <= 0.63, finite), project lon/lat to the
polar-stereographic grid, and average into (G, G) daily bins over the
[0, 8e6]^2 m domain.

Copy of ``optimalinterpolation_tpu/data/binner.py``. The ``.proc`` files
are parsed by the port's C++ parser (``native.parse_proc``) with no
``genfromtxt`` fallback: a file it cannot parse raises. ``np.genfromtxt`` is
the plain version the tests hold it against.
"""

from __future__ import annotations

import glob
import os
from typing import Iterable

import numpy as np

from optimalinterpolation_tpu_torch import native
from optimalinterpolation_tpu_torch.data.projection import PolarStereo
from optimalinterpolation_tpu_torch.io.pickles import save_pickle

__all__ = ["SEASONS", "bin_points", "read_proc_file", "read_and_bin_day", "run_season_binning"]

FB_MIN, FB_MAX = -0.37, 0.63  # read_and_bin.py:44
VALID_FLAG = 2
GRID_EXTENT_M = 8.0e6

# Reference season tables (read_and_bin.py:65-72)
SEASONS = {
    "2018-2019": dict(
        months=["201811", "201812", "201901", "201902", "201903", "201904"],
        days=[30, 31, 31, 28, 31, 30],
        version="v1",
    ),
    "2019-2020": dict(
        months=["201911", "201912", "202001", "202002", "202003", "202004"],
        days=[30, 31, 31, 29, 31, 30],
        version="v3",
    ),
}


def read_proc_file(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lon, lat, fb) of valid returns in one .proc file."""
    data = native.parse_proc(path)
    fb = data[:, 4]
    valid = (data[:, 7] == VALID_FLAG) & (fb >= FB_MIN) & (fb <= FB_MAX) & np.isfinite(fb)
    return data[valid, 0], data[valid, 1], fb[valid]


def bin_points(
    x: np.ndarray, y: np.ndarray, values: np.ndarray, grid_res_km: int
) -> np.ndarray:
    """Mean-per-cell binning over [0, 8e6]^2 (binned_statistic_2d(nanmean)
    semantics, incl. the reference's final ``.T``: output is indexed [ix, iy]
    with ix from the x coordinate).

    Uses bincount accumulation — O(n) and C-speed — instead of scipy's
    generic statistic machinery.
    """
    n = int(GRID_EXTENT_M / (grid_res_km * 1000))
    res = GRID_EXTENT_M / n
    ix = np.floor(x / res).astype(np.int64)
    iy = np.floor(y / res).astype(np.int64)
    ok = (ix >= 0) & (ix < n) & (iy >= 0) & (iy < n) & np.isfinite(values)
    flat = ix[ok] * n + iy[ok]
    ssum = np.bincount(flat, weights=values[ok], minlength=n * n)
    cnt = np.bincount(flat, minlength=n * n)
    with np.errstate(invalid="ignore"):
        out = ssum / cnt
    return out.reshape(n, n)


def read_and_bin_day(
    files: Iterable[str], grid_res_km: int, proj: PolarStereo | None = None
) -> np.ndarray | None:
    """Bin all of one day's .proc files to a (G, G) field; None if no files."""
    files = list(files)
    if not files:
        return None
    proj = proj or PolarStereo.from_boundinglat(60.0, 0.0)
    lons, lats, fbs = [], [], []
    for f in files:
        lo, la, fb = read_proc_file(f)
        lons.append(lo)
        lats.append(la)
        fbs.append(fb)
    lon = np.concatenate(lons)
    lat = np.concatenate(lats)
    fb = np.concatenate(fbs)
    x, y = proj.forward(lon, lat)
    return bin_points(x, y, fb, grid_res_km)


def run_season_binning(
    datapath: str,
    outdir: str,
    sat: str,
    season: str,
    grid_res_km: int,
) -> dict:
    """Full C1 flow: glob per month/day, bin, write the season pickle +
    coordinate ``.npy`` files (read_and_bin.py:36-57 layout)."""
    cfg = SEASONS[season]
    fields = {}
    for month, ndays in zip(cfg["months"], cfg["days"]):
        for day in range(ndays):
            date = f"{month}{day + 1:02d}"
            files = sorted(
                glob.glob(
                    os.path.join(datapath, month, f"*{date}*{cfg['version']}.proc")
                )
            )
            field = read_and_bin_day(files, grid_res_km)
            if field is not None:
                fields[date] = field
    os.makedirs(outdir, exist_ok=True)
    save_pickle(
        fields,
        os.path.join(
            outdir, f"{sat}_dailyFB_{grid_res_km}km_{season}_season.pkl"
        ),
    )
    xpath = os.path.join(outdir, f"x_{grid_res_km}km.npy")
    if not os.path.exists(xpath):
        n = int(GRID_EXTENT_M / (grid_res_km * 1000))
        coords = np.linspace(0.0, GRID_EXTENT_M, n + 1)[:-1]
        gx, gy = np.meshgrid(coords, coords, indexing="ij")
        np.save(xpath, gx)
        np.save(os.path.join(outdir, f"y_{grid_res_km}km.npy"), gy)
    return fields
