"""The port's quicklook NetCDF without h5py (``io/hdf5.py``) against the JAX
package's, which h5py writes.

With h5py blocked, the port writes a quicklook field; h5py then reads it to
the same datasets (names, shapes, ``<f8``, values bit for bit with NaNs in
place) and the same attributes (names, ``np.bytes_``, string size, padding
and character set) as the JAX package's file of the same field. The port's
``read_quicklook`` reads both files without h5py. Files outside the subset
(chunked and compressed, or the newest file format) make ``read_hdf5``
raise ``ValueError``; ``read_quicklook`` then reads them with h5py, and
without it raises the ``RuntimeError`` that names h5py.
"""

import re
import sys

import h5py
import numpy as np
import pytest

from optimalinterpolation_tpu.io import quicklook as JQ
from optimalinterpolation_tpu_torch.io import quicklook as TQ
from optimalinterpolation_tpu_torch.io.hdf5 import read_hdf5

NAMES = ("lat", "lon", "radar_freeboard", "uncertainty")


def _field(shape, seed=0) -> TQ.QuicklookField:
    """Random fields of ``shape``, NaN at random cells of the two products."""
    rng = np.random.default_rng(seed)
    arrays = {name: rng.normal(size=shape) for name in NAMES}
    for name in ("radar_freeboard", "uncertainty"):
        arrays[name][rng.random(shape) < 0.3] = np.nan
    return TQ.QuicklookField(date="20181205", **arrays)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64).view(np.uint64)


def _described(path) -> dict:
    """Every dataset's shape, dtype and bits, and every attribute's value
    and string type, as h5py reads them."""

    def attrs(obj):
        out = {}
        for key in obj.attrs:
            value, tid = obj.attrs[key], obj.attrs.get_id(key).get_type()
            if key == "date_created":  # today's date in both packages
                assert re.fullmatch(rb"\d{8}", value)
                value = b"YYYYMMDD"
            out[key] = (type(value), value, tid.get_class(), tid.get_size(),
                        tid.get_strpad(), tid.get_cset())
        return out

    with h5py.File(path, "r") as f:
        return {"root": attrs(f), "names": sorted(f),
                **{k: (f[k].shape, f[k].dtype.str, _bits(f[k][()]).tobytes(), attrs(f[k]))
                   for k in f}}


@pytest.mark.parametrize("shape", [(320, 320), (13, 7), (1, 1)], ids=str)
def test_port_file_reads_in_h5py_as_the_jax_file(shape, tmp_path, monkeypatch):
    field = _field(shape)
    port, ref = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)  # ``import h5py`` raises ImportError
        TQ.write_quicklook(field, port)
    JQ.write_quicklook(field, ref)
    got, want = _described(port), _described(ref)
    assert got == want
    assert got["names"] == list(NAMES)
    for name in NAMES:
        assert got[name][:2] == (shape, "<f8")
        assert got[name][2] == _bits(getattr(field, name)).tobytes()
    assert got["root"]["title"][0] is np.bytes_  # a scalar, not an array
    assert got["root"]["title"][1] == b"20181205 CS2S3 radar freeboard and uncertainty"


def test_read_quicklook_without_h5py_reads_both_packages(tmp_path, monkeypatch):
    field = _field((17, 11), seed=1)
    port, ref = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    TQ.write_quicklook(field, port)
    JQ.write_quicklook(field, ref)
    monkeypatch.setitem(sys.modules, "h5py", None)
    for path in (port, ref):
        q = TQ.read_quicklook(path)
        assert q.date == "20181205"
        for name in NAMES:
            a = getattr(q, name)
            assert a.dtype == np.float64 and a.flags.owndata and a.flags.writeable
            np.testing.assert_array_equal(_bits(a), _bits(getattr(field, name)))
    data, dataset_attrs, root_attrs = read_hdf5(ref)
    assert list(data) == list(NAMES)
    assert dataset_attrs["uncertainty"] == {"units": b"metres",
                                            "standard_name": b"radar_freeboard_uncertainty"}
    assert root_attrs["data_type"] == b"Quick Look"


def _h5py_file(path, field, **kw):
    """The quicklook schema through h5py with the dataset keywords or file
    format ``kw`` (``libver`` goes to the file)."""
    libver = kw.pop("libver", None)
    with h5py.File(path, "w", libver=libver) as f:
        for name in NAMES:
            f.create_dataset(name, data=getattr(field, name), **kw)
        f.attrs["title"] = np.bytes_(f"{field.date} CS2S3".encode())


@pytest.mark.parametrize("kw, met", [
    ({"chunks": (4, 4), "compression": "gzip"}, "filter pipeline"),
    ({"libver": "latest"}, "superblock version 3"),
], ids=["chunked-gzip", "libver-latest"])
def test_outside_the_subset_falls_back_to_h5py(kw, met, tmp_path, monkeypatch):
    field = _field((9, 8), seed=2)
    path = str(tmp_path / "other.nc")
    _h5py_file(path, field, **kw)
    with pytest.raises(ValueError, match=met):
        read_hdf5(path)
    q = TQ.read_quicklook(path)  # h5py present
    assert q.date == "20181205"
    for name in NAMES:
        np.testing.assert_array_equal(_bits(getattr(q, name)), _bits(getattr(field, name)))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="h5py is required") as err:
        TQ.read_quicklook(path)
    assert isinstance(err.value.__cause__, ValueError) and met in str(err.value.__cause__)
