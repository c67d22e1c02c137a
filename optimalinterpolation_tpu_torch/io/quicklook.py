"""Quicklook NetCDF output (reference data-product schema).

The reference publishes daily fields as NetCDF4 files
(``QuickLook Data/CS2S3_YYYYMMDD_25km_quicklook.nc``) with variables ``lat``,
``lon`` (320x320 float64), ``radar_freeboard`` and ``uncertainty`` [m], plus
global attrs title/file_created_by/date_created/data_type. NetCDF4 is HDF5
underneath, with netCDF-compatible names, so downstream netCDF tooling opens
these files unchanged.

Copy of ``optimalinterpolation_tpu/io/quicklook.py``, kept because importing
any module of that package imports JAX; ``tests/test_torch_data.py`` pins the
two equal. One difference: the bytes are written and read by ``io/hdf5.py``
(numpy and ``struct``) instead of h5py, in the layout h5py writes, so the
port writes and reads its own and the JAX package's files without h5py.
h5py is needed only to read a file outside that subset, such as the
reference's netCDF4-library files.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import os

import numpy as np

from optimalinterpolation_tpu_torch.io.hdf5 import read_hdf5, write_hdf5

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


def write_quicklook(field: QuicklookField, path: str, creator: str | None = None) -> None:
    """Write one daily field in the reference quicklook schema."""
    if field.radar_freeboard.shape[0] != field.lat.shape[0]:
        raise ValueError(f"field grid {field.radar_freeboard.shape} != lat grid {field.lat.shape}")
    write_hdf5(
        path,
        {"lat": field.lat, "lon": field.lon, "radar_freeboard": field.radar_freeboard,
         "uncertainty": field.uncertainty},
        {"lat": {"units": b"degrees_north", "long_name": b"latitude"},
         "lon": {"units": b"degrees_east", "long_name": b"longitude"},
         "radar_freeboard": {"units": b"metres", "standard_name": b"radar_freeboard"},
         "uncertainty": {"units": b"metres", "standard_name": b"radar_freeboard_uncertainty"}},
        {"title": f"{field.date} CS2S3 radar freeboard and uncertainty".encode(),
         "file_created_by": (creator or "optimalinterpolation-tpu").encode(),
         "date_created": _dt.date.today().strftime("%Y%m%d").encode(),
         "data_type": b"Quick Look"},
    )


def _read_h5py(path: str, err: ValueError) -> tuple:
    """The quicklook datasets and root attributes of a file outside
    ``io/hdf5.py``'s subset, through h5py."""
    try:
        import h5py
    except ImportError:
        raise RuntimeError(f"h5py is required to read {path}, which io/hdf5.py cannot "
                           f"read") from err
    with h5py.File(path, "r") as f:
        names = ("lat", "lon", "_nc4_non_coord_lon", "radar_freeboard", "uncertainty")
        return {k: f[k][()] for k in names if k in f}, {"title": f.attrs.get("title", b"")}


def read_quicklook(path: str) -> QuicklookField:
    """Read a quicklook file, ours or one shipped with the reference.

    The reference files store ``lon`` under the netCDF4 mangled name
    ``_nc4_non_coord_lon`` (a non-coordinate variable clashing with a
    dimension name); both spellings are accepted. Files outside
    ``io/hdf5.py``'s subset (the netCDF4 library's) are read with h5py.
    """
    try:
        data, _, attrs = read_hdf5(path)
    except ValueError as err:
        data, attrs = _read_h5py(path, err)
    lon_key = "_nc4_non_coord_lon" if "_nc4_non_coord_lon" in data else "lon"
    title = attrs.get("title", b"")
    if isinstance(title, bytes):
        title = title.decode(errors="replace")
    date = title.split(" ")[0] if title else ""
    return QuicklookField(
        date=date,
        lat=data["lat"],
        lon=data[lon_key],
        radar_freeboard=data["radar_freeboard"],
        uncertainty=data["uncertainty"],
    )
