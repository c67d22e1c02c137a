"""Quicklook NetCDF output (reference data-product schema).

The reference publishes daily fields as NetCDF4 files
(``QuickLook Data/CS2S3_YYYYMMDD_25km_quicklook.nc``) with variables ``lat``,
``lon`` (320x320 float64), ``radar_freeboard`` and ``uncertainty`` [m], plus
global attrs title/file_created_by/date_created/data_type. NetCDF4 is HDF5
underneath, so these files are read and written with h5py, with
netCDF-compatible names, so downstream netCDF tooling opens them unchanged.

Copy of ``optimalinterpolation_tpu/io/quicklook.py``, kept because importing
any module of that package imports JAX; ``tests/test_torch_data.py`` pins the
two equal. One difference: h5py is imported only when a file is written or
read, so the port imports without it (the card's machine may lack it).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import os

import numpy as np

__all__ = [
    "QuicklookField",
    "write_quicklook",
    "read_quicklook",
    "grid_lonlat",
    "write_result_quicklook",
]


def grid_lonlat(x: np.ndarray, y: np.ndarray):
    """(lon, lat) for the production grid (npstere boundinglat=60 lon_0=0,
    ``read_and_bin.py:59``)."""
    from optimalinterpolation_tpu_torch.data.projection import PolarStereo

    return PolarStereo.from_boundinglat(60.0, 0.0).inverse(x, y)


def write_result_quicklook(res, lon, lat, grid_res_km: int, outdir: str) -> str:
    """Write one daily result as a reference-schema quicklook file.

    The single encoding of the orientation contract: internal fields are
    [ix, iy]; the reference's files are [iy, ix], so everything is transposed
    here, and the filename follows ``CS2S3_{date}_{res}km_quicklook.nc``.
    ``res`` is any object with ``date``, ``interp_smth`` and
    ``interp_error_smth`` (``pipeline.daily.DailyResult``)."""
    path = os.path.join(outdir, f"CS2S3_{res.date}_{grid_res_km}km_quicklook.nc")
    write_quicklook(
        QuicklookField(
            date=res.date,
            lat=lat.T,
            lon=lon.T,
            radar_freeboard=res.interp_smth.T,
            uncertainty=res.interp_error_smth.T,
        ),
        path,
    )
    return path


@dataclasses.dataclass
class QuicklookField:
    date: str  # yyyymmdd
    lat: np.ndarray  # (G, G)
    lon: np.ndarray  # (G, G)
    radar_freeboard: np.ndarray  # (G, G) [m]
    uncertainty: np.ndarray  # (G, G) [m]


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("h5py is required for quicklook NetCDF I/O") from e
    return h5py


def write_quicklook(field: QuicklookField, path: str, creator: str | None = None) -> None:
    """Write one daily field in the reference quicklook schema."""
    h5py = _h5py()
    if field.radar_freeboard.shape[0] != field.lat.shape[0]:
        raise ValueError(f"field grid {field.radar_freeboard.shape} != lat grid {field.lat.shape}")
    with h5py.File(path, "w") as f:
        lat = f.create_dataset("lat", data=field.lat.astype(np.float64))
        lon = f.create_dataset("lon", data=field.lon.astype(np.float64))
        fb = f.create_dataset("radar_freeboard", data=field.radar_freeboard.astype(np.float64))
        un = f.create_dataset("uncertainty", data=field.uncertainty.astype(np.float64))
        lat.attrs["units"] = np.bytes_(b"degrees_north")
        lat.attrs["long_name"] = np.bytes_(b"latitude")
        lon.attrs["units"] = np.bytes_(b"degrees_east")
        lon.attrs["long_name"] = np.bytes_(b"longitude")
        fb.attrs["units"] = np.bytes_(b"metres")
        fb.attrs["standard_name"] = np.bytes_(b"radar_freeboard")
        un.attrs["units"] = np.bytes_(b"metres")
        un.attrs["standard_name"] = np.bytes_(b"radar_freeboard_uncertainty")
        f.attrs["title"] = np.bytes_(
            f"{field.date} CS2S3 radar freeboard and uncertainty".encode()
        )
        f.attrs["file_created_by"] = np.bytes_(
            (creator or "optimalinterpolation-tpu").encode()
        )
        f.attrs["date_created"] = np.bytes_(_dt.date.today().strftime("%Y%m%d").encode())
        f.attrs["data_type"] = np.bytes_(b"Quick Look")


def read_quicklook(path: str) -> QuicklookField:
    """Read a quicklook file, ours or one shipped with the reference.

    The reference files store ``lon`` under the netCDF4 mangled name
    ``_nc4_non_coord_lon`` (a non-coordinate variable clashing with a
    dimension name); both spellings are accepted.
    """
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        lon_key = "_nc4_non_coord_lon" if "_nc4_non_coord_lon" in f else "lon"
        title = f.attrs.get("title", b"")
        if isinstance(title, bytes):
            title = title.decode(errors="replace")
        date = title.split(" ")[0] if title else ""
        return QuicklookField(
            date=date,
            lat=f["lat"][()],
            lon=f[lon_key][()],
            radar_freeboard=f["radar_freeboard"][()],
            uncertainty=f["uncertainty"][()],
        )
