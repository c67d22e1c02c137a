"""The reference's neighbourhood (``GPR_CS2S3.py:159-161,246``), in numpy:
every finite observation of the T-day window whose grid cell lies within
the radius of the cell (``<=``), in the order of the window's flat index
(i, j, satellite, day).

Observations sit at grid-cell centres, so membership depends only on the
offset between two cells: :func:`disc_offsets` lists the offsets within the
radius once, and the neighbour counts of every cell are sums of shifted
per-cell counts.
"""

from __future__ import annotations

import numpy as np


def window_points(obs: np.ndarray, x: np.ndarray, y: np.ndarray, start: int, days: int):
    """The window's finite observations: (gi, gj, xyt (n, 3), z (n,)), in
    flat-index order of ``obs[:, :, :, start:start + days]``."""
    win = obs[:, :, :, start:start + days]
    gi, gj, _, ti = np.nonzero(np.isfinite(win))
    xyt = np.stack([x[gi, gj], y[gi, gj], ti.astype(np.float64)], axis=1)
    return gi, gj, xyt, win[np.isfinite(win)]


def disc_offsets(x: np.ndarray, y: np.ndarray, radius_m: float) -> np.ndarray:
    """(k, 2) grid offsets (di, dj) of the cells within ``radius_m`` of a
    cell, on a regular grid."""
    dx, dy = x[1, 0] - x[0, 0], y[0, 1] - y[0, 0]
    n = int(radius_m // min(abs(dx), abs(dy))) + 1
    di, dj = np.meshgrid(np.arange(-n, n + 1), np.arange(-n, n + 1), indexing="ij")
    keep = (di * dx) ** 2 + (dj * dy) ** 2 <= radius_m ** 2
    return np.stack([di[keep], dj[keep]], axis=1)


def neighbour_counts(per_cell: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """(G, G) number of observations within the radius of each cell, from
    the (G, G) count of observations at each cell."""
    g0, g1 = per_cell.shape
    out = np.zeros(per_cell.shape, np.int64)
    for di, dj in offsets:
        src = per_cell[max(di, 0):g0 + min(di, 0), max(dj, 0):g1 + min(dj, 0)]
        out[max(-di, 0):g0 + min(-di, 0), max(-dj, 0):g1 + min(-dj, 0)] += src
    return out


def neighbourhood(cell: tuple, gi, gj, offsets, shape) -> np.ndarray:
    """Indices into the window's points of ``cell``'s neighbourhood,
    ascending."""
    near = np.zeros(shape, bool)
    ii, jj = cell[0] + offsets[:, 0], cell[1] + offsets[:, 1]
    ok = (ii >= 0) & (ii < shape[0]) & (jj >= 0) & (jj < shape[1])
    near[ii[ok], jj[ok]] = True
    return np.nonzero(near[gi, gj])[0]


def bucket_of(count: int, buckets) -> int:
    """The smallest bucket that holds ``count`` points, else the largest."""
    for b in sorted(buckets):
        if count <= b:
            return b
    return max(buckets)
