"""Polar-stereographic grid projections (reference component C15).

The reference mixes two implementations of the same projection:
  * Basemap ``npstere`` (boundinglat=60, lon_0=0) in production
    (the reference's ``2021_paper_production/read_and_bin.py:59``), and
  * a hand-rolled pyproj spherical stereographic (R=6370997 m) with a
    corner-registration shift in the dev notebook
    (``dev/sparseGP_example.ipynb`` cell-1 ``grid_proj``).

This is a dependency-free NumPy implementation of the dev-notebook variant:
spherical north-polar stereographic, true scale at the pole, with the origin
shifted so the lower-left corner of the (boundinglat-defined) square domain
maps to (0, 0) — matching Basemap's npstere coordinate convention of
[0, 8e6]^2 m for boundinglat=60.

Copy of ``optimalinterpolation_tpu/data/projection.py``, kept because
importing any module of that package imports JAX;
``tests/test_torch_data.py`` pins the two equal. ``io.quicklook.grid_lonlat``
uses it for the quicklook NetCDFs' lat/lon.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PolarStereo", "north_polar_grid"]

EARTH_RADIUS_M = 6370997.0  # grid_proj's +R (Basemap sphere)


@dataclasses.dataclass(frozen=True)
class PolarStereo:
    """North-polar spherical stereographic with an (x0, y0) origin shift."""

    lon_0: float = 0.0
    x0: float = 0.0
    y0: float = 0.0
    radius: float = EARTH_RADIUS_M

    def forward(self, lon, lat):
        """(lon, lat) degrees -> (x, y) metres."""
        lon = np.radians(np.asarray(lon, dtype=np.float64))
        lat = np.radians(np.asarray(lat, dtype=np.float64))
        lam0 = np.radians(self.lon_0)
        rho = 2.0 * self.radius * np.tan(np.pi / 4.0 - lat / 2.0)
        x = rho * np.sin(lon - lam0) + self.x0
        y = -rho * np.cos(lon - lam0) + self.y0
        return x, y

    def inverse(self, x, y):
        """(x, y) metres -> (lon, lat) degrees."""
        xs = np.asarray(x, dtype=np.float64) - self.x0
        ys = np.asarray(y, dtype=np.float64) - self.y0
        rho = np.hypot(xs, ys)
        lat = np.degrees(np.pi / 2.0 - 2.0 * np.arctan(rho / (2.0 * self.radius)))
        lon = np.degrees(np.arctan2(xs, -ys)) + self.lon_0
        lon = (lon + 180.0) % 360.0 - 180.0
        return lon, lat

    @classmethod
    def from_boundinglat(cls, boundinglat: float = 60.0, lon_0: float = 0.0):
        """grid_proj's default mode: origin at the lower-left corner of the
        square domain whose inscribed circle touches ``boundinglat``.

        The corner latitude satisfies rho_corner = sqrt(2) * rho(boundinglat)
        (the corner of the square sits at 45 deg from the bounding circle's
        tangent points), matching the notebook's ``sqrt(2) * y_`` trick.
        """
        base = cls(lon_0=lon_0)
        _, y_b = base.forward(lon_0, boundinglat)
        rho_corner = np.sqrt(2.0) * abs(y_b)
        # corner azimuth: lon_0 - 45 deg (llcrnrlon in the notebook)
        ang = np.radians(-45.0)
        xc = rho_corner * np.sin(ang)
        yc = -rho_corner * np.cos(ang)
        return cls(lon_0=lon_0, x0=-xc, y0=-yc)


def north_polar_grid(grid_res_km: int, boundinglat: float = 60.0, lon_0: float = 0.0):
    """Cell-corner coordinate grids (x, y, lon, lat) for the production
    domain: [0, 8e6]^2 m at ``grid_res_km`` (read_and_bin.py:32,48-49)."""
    n = int(8.0e6 / (grid_res_km * 1000))
    coords = np.linspace(0.0, 8.0e6, n + 1)[:-1]
    gx, gy = np.meshgrid(coords, coords, indexing="ij")
    proj = PolarStereo.from_boundinglat(boundinglat, lon_0)
    lon, lat = proj.inverse(gx, gy)
    return gx, gy, lon, lat
