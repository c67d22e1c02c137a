"""Grid-to-grid regridding of gridded fields (reference component C2).

Copy of ``optimalinterpolation_tpu/data/regrid.py`` (numpy and SciPy's
kd-tree only), kept because importing anything from that package imports
JAX; ``tests/test_torch_data.py`` and ``tests/test_torch_regrid_validation.py``
pin the two equal. It rebuilds ``regrid_xesmf.py`` without the xESMF/ESMF
stack:

  * bilinear interpolation between regular grids (separable index
    arithmetic; xesmf's ``method='bilinear'`` on the interior),
  * nearest-neighbour fill of NaN holes,
  * ocean masking by a committed ice-capable-ocean mask
    (``static/ocean_mask_25km.npz``, a copy of the JAX package's: the union
    footprint of the reference's 232 published quicklook products) in place
    of the reference's ``global_land_mask``, resampled to any grid by
    :func:`load_ocean_mask`; by default, the product's own footprint.

The ``hypers`` command regrids seasonal-average hyperparameter fields with
it (the quicklook path, ``QuickLook Data/README.txt:1``), and the daily
pipeline spreads seed cells' and a previous day's hyperparameters over the
grid with :func:`nearest_fill`.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.spatial import cKDTree

__all__ = ["bilinear_regrid", "nearest_fill", "regrid_field", "load_ocean_mask"]


def load_ocean_mask(
    dst_x: np.ndarray | None = None, dst_y: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The committed ice-capable-ocean mask (replaces ``global_land_mask``).

    Derived from the union footprint of the reference's 232 published
    quicklook NetCDFs (see tools/derive_ocean_mask.py): True = a 25 km polar
    stereographic cell that carried finite freeboard on at least one
    published day. With ``dst_x/dst_y`` given (1-D or 2-D cell-centre
    coords), the mask is nearest-neighbour resampled onto that grid.

    Returns ``(mask, x, y)`` on the requested (or native 320x320/25 km) grid.
    """
    path = os.path.join(
        os.path.dirname(__file__), "static", "ocean_mask_25km.npz"
    )
    with np.load(path) as z:
        mask, x, y = z["mask"], z["x"], z["y"]
    if dst_x is None:
        return mask, x, y
    gx = dst_x if np.ndim(dst_x) == 2 else np.meshgrid(dst_x, dst_y)[0]
    gy = dst_y if np.ndim(dst_y) == 2 else np.meshgrid(dst_x, dst_y)[1]
    ix = np.clip(np.searchsorted(x, gx.ravel()) - 0, 0, x.size - 1)
    # snap to the NEAREST source cell centre (searchsorted gives the right
    # neighbour; compare with the left one)
    left = np.clip(ix - 1, 0, x.size - 1)
    ix = np.where(
        np.abs(x[left] - gx.ravel()) <= np.abs(x[ix] - gx.ravel()), left, ix
    )
    iy = np.clip(np.searchsorted(y, gy.ravel()), 0, y.size - 1)
    lefty = np.clip(iy - 1, 0, y.size - 1)
    iy = np.where(
        np.abs(y[lefty] - gy.ravel()) <= np.abs(y[iy] - gy.ravel()), lefty, iy
    )
    out = mask[iy, ix].reshape(gx.shape)
    return out, dst_x, dst_y


def bilinear_regrid(
    src: np.ndarray,  # (ny, nx) source field (NaN = missing)
    src_x: np.ndarray,  # (nx,) or (ny, nx) source coords
    src_y: np.ndarray,
    dst_x: np.ndarray,  # (my,) / (my, mx) destination coords
    dst_y: np.ndarray,
) -> np.ndarray:
    """Bilinear interpolation from one regular grid to another.

    NaN-aware: a destination point whose 4 surrounding source cells are all
    NaN comes out NaN; partial NaN neighbourhoods renormalize the weights
    (xesmf's behaviour with ``skipna``-style handling).
    """
    sx = np.asarray(src_x[0] if np.ndim(src_x) == 2 else src_x, dtype=np.float64)
    sy = np.asarray(
        src_y[:, 0] if np.ndim(src_y) == 2 else src_y, dtype=np.float64
    )
    dx = np.asarray(dst_x if np.ndim(dst_x) == 2 else np.meshgrid(dst_x, dst_y)[0])
    dy = np.asarray(dst_y if np.ndim(dst_y) == 2 else np.meshgrid(dst_x, dst_y)[1])

    fx = np.interp(dx.ravel(), sx, np.arange(len(sx)))
    fy = np.interp(dy.ravel(), sy, np.arange(len(sy)))
    ix = np.clip(fx.astype(np.int64), 0, len(sx) - 2)
    iy = np.clip(fy.astype(np.int64), 0, len(sy) - 2)
    tx = np.clip(fx - ix, 0.0, 1.0)
    ty = np.clip(fy - iy, 0.0, 1.0)

    corners = [
        (src[iy, ix], (1 - ty) * (1 - tx)),
        (src[iy, ix + 1], (1 - ty) * tx),
        (src[iy + 1, ix], ty * (1 - tx)),
        (src[iy + 1, ix + 1], ty * tx),
    ]
    num = np.zeros(dx.size)
    den = np.zeros(dx.size)
    for v, wgt in corners:
        good = np.isfinite(v)
        num += np.where(good, v * wgt, 0.0)
        den += np.where(good, wgt, 0.0)
    out = np.where(den > 0, num / np.where(den > 0, den, 1.0), np.nan)
    return out.reshape(dx.shape)


def nearest_fill(
    field: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    valid_mask: np.ndarray | None = None,
) -> np.ndarray:
    """Fill NaNs with the nearest finite value (the reference's NaN fill).

    ``valid_mask`` restricts which NaN pixels get filled (e.g. ocean only);
    pixels outside it stay NaN.
    """
    gx = x if np.ndim(x) == 2 else np.meshgrid(x, y)[0]
    gy = y if np.ndim(y) == 2 else np.meshgrid(x, y)[1]
    finite = np.isfinite(field)
    if not finite.any():
        return field.copy()
    holes = ~finite if valid_mask is None else (~finite) & valid_mask
    if not holes.any():
        return field.copy()
    tree = cKDTree(np.column_stack([gx[finite], gy[finite]]))
    _, idx = tree.query(np.column_stack([gx[holes], gy[holes]]))
    out = field.copy()
    out[holes] = field[finite][idx]
    return out


def regrid_field(
    src: np.ndarray,
    src_x: np.ndarray,
    src_y: np.ndarray,
    dst_x: np.ndarray,
    dst_y: np.ndarray,
    fill: bool = True,
    ocean_mask: np.ndarray | str | None = None,
) -> np.ndarray:
    """The full reference C2 flow: bilinear regrid -> NaN fill -> mask.

    ``ocean_mask`` (destination-shaped bool, True = ocean) replaces the
    reference's ``global_land_mask``. ``"builtin"`` loads the committed
    quicklook-derived mask (:func:`load_ocean_mask`) resampled to the
    destination grid — use it for real 2018-2019-domain products; the
    default ``None`` masks by the regridded validity footprint itself (SIC
    products are ocean-only by construction; also correct for synthetic
    data, whose ice ignores real coastlines).
    """
    out = bilinear_regrid(src, src_x, src_y, dst_x, dst_y)
    if isinstance(ocean_mask, str):
        if ocean_mask != "builtin":
            raise ValueError(f"unknown ocean_mask {ocean_mask!r}")
        ocean_mask, _, _ = load_ocean_mask(dst_x, dst_y)
    if ocean_mask is None:
        ocean_mask = np.isfinite(
            nearest_fill(out, dst_x, dst_y)
        )  # footprint of the product
    if fill:
        out = nearest_fill(out, dst_x, dst_y, valid_mask=ocean_mask)
    out = np.where(ocean_mask, out, np.nan)
    return out
