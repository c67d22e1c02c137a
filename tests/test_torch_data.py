"""The port's copies of the numpy data plane give the JAX package's arrays.

window / reader / synthetic / prior / regrid's nearest_fill / projection
and the quicklook NetCDF I/O must agree exactly, and so must the
neighborhood buckets, every array of them (``tests/test_torch_gather.py``
holds the gather to more cases).
"""

import dataclasses
import os

import numpy as np
import pytest

from optimalinterpolation_tpu.data import neighbors as JN
from optimalinterpolation_tpu.data import prior as JP
from optimalinterpolation_tpu.data import projection as JPr
from optimalinterpolation_tpu.data import reader as JR
from optimalinterpolation_tpu.data import regrid as JG
from optimalinterpolation_tpu.data import synthetic as JS
from optimalinterpolation_tpu.data import window as JW
from optimalinterpolation_tpu.io import quicklook as JQ
from optimalinterpolation_tpu_torch.data import neighbors as TN
from optimalinterpolation_tpu_torch.data import prior as TP
from optimalinterpolation_tpu_torch.data import projection as TPr
from optimalinterpolation_tpu_torch.data import reader as TR
from optimalinterpolation_tpu_torch.data import regrid as TG
from optimalinterpolation_tpu_torch.data import synthetic as TS
from optimalinterpolation_tpu_torch.data import window as TW
from optimalinterpolation_tpu_torch.io import quicklook as TQ


@pytest.fixture(scope="module")
def seasons(tmp_path_factory):
    """The same synthetic season written by both packages (100 km, 9 days)."""
    out = {}
    for tag, mod in (("jax", JS), ("torch", TS)):
        d = str(tmp_path_factory.mktemp(tag))
        out[tag] = (d, mod.make_synthetic_season(d, grid_res_km=100, n_days=9, seed=11))
    return out


def test_synthetic_and_reader_match(seasons):
    (dj, (truth_j, dates_j)), (dt, (truth_t, dates_t)) = seasons["jax"], seasons["torch"]
    np.testing.assert_array_equal(truth_t, truth_j)
    assert dates_t == dates_j
    a = JR.read_freeboard_season(dj, 100, "2018-2019")
    b = TR.read_freeboard_season(dt, 100, "2018-2019")
    for name in ("obs", "sie", "x", "y"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)
    assert b.dates == a.dates and b.grid_res_km == a.grid_res_km
    assert tuple(b.satellites) == tuple(a.satellites)


def test_window_and_prior_match(seasons):
    d, _ = seasons["torch"]
    ds = TR.read_freeboard_season(d, 100, "2018-2019")
    a = JW.flatten_window(ds.obs, ds.x, ds.y)
    b = TW.flatten_window(ds.obs, ds.x, ds.y)
    for name in ("x", "y", "t", "z", "xyt", "xy"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)
    fyi = np.load(f"{d}/CS2_FYI_synthetic_100km.npy")
    assert TP.constant_fyi_prior(fyi, 0, offset=0) == JP.constant_fyi_prior(fyi, 0, offset=0)
    with pytest.raises(ValueError, match="empty"):
        TP.constant_fyi_prior(fyi, 0)  # the reference product's offset 16 overruns 9 days


@pytest.mark.parametrize("buckets", [(512, 1024, 2048, 4096), (64, 128, 256)])
def test_gather_neighborhoods_matches(seasons, buckets):
    d, _ = seasons["torch"]
    ds = TR.read_freeboard_season(d, 100, "2018-2019")
    train = TW.flatten_window(ds.obs, ds.x, ds.y)
    ij = np.nonzero(np.isfinite(ds.sie[:, :, 4]))
    cells = np.stack([ds.x[ij], ds.y[ij]], axis=1)
    kw = dict(t_star=4.0, radius_m=300e3, buckets=buckets, dtype=np.float64)
    a = JN.gather_neighborhoods(train, cells, **kw)
    b = TN.gather_neighborhoods(train, cells, **kw)
    assert [x.capacity for x in b] == [x.capacity for x in a] and len(a) > 0
    for ba, bb in zip(a, b):
        assert bb.n_valid_cells == ba.n_valid_cells
        for name in ("cell_index", "xstar", "mask", "x", "z"):
            np.testing.assert_array_equal(getattr(bb, name), getattr(ba, name), err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_nearest_fill_matches(masked):
    rng = np.random.default_rng(5)
    g = 30
    x, y = np.meshgrid(np.arange(g) * 25e3, np.arange(g) * 25e3, indexing="ij")
    field = rng.normal(size=(g, g))
    field[rng.random((g, g)) < 0.6] = np.nan
    valid = rng.random((g, g)) < 0.7 if masked else None
    a = JG.nearest_fill(field, x, y, valid_mask=valid)
    b = TG.nearest_fill(field, x, y, valid_mask=valid)
    np.testing.assert_array_equal(b, a)
    assert np.isfinite(b).sum() > np.isfinite(field).sum()
    if masked:
        assert np.isnan(b[~valid & np.isnan(field)]).all()
    empty = np.full((g, g), np.nan)
    np.testing.assert_array_equal(TG.nearest_fill(empty, x, y), JG.nearest_fill(empty, x, y))
    # 1-D coordinate vectors are meshed as the JAX package meshes them
    np.testing.assert_array_equal(TG.nearest_fill(field, x[:, 0], y[0]),
                                  JG.nearest_fill(field, x[:, 0], y[0]))


def test_projection_and_grid_lonlat_match():
    """The production 25 km grid: corner grids, lon/lat of the cells and the
    forward projection back."""
    a, b = JPr.north_polar_grid(25), TPr.north_polar_grid(25)
    assert a[0].shape == (320, 320)
    for ga, gb in zip(a, b):
        np.testing.assert_array_equal(gb, ga)
    lon, lat = TQ.grid_lonlat(a[0], a[1])
    jlon, jlat = JQ.grid_lonlat(a[0], a[1])
    np.testing.assert_array_equal(lon, jlon)
    np.testing.assert_array_equal(lat, jlat)
    assert 30.0 < lat.min() and lat.max() < 90.0
    proj, jproj = TPr.PolarStereo.from_boundinglat(60.0), JPr.PolarStereo.from_boundinglat(60.0)
    assert dataclasses.astuple(proj) == dataclasses.astuple(jproj)
    for got, ref in zip(proj.forward(lon, lat), jproj.forward(lon, lat)):
        np.testing.assert_array_equal(got, ref)


def test_quicklook_round_trip_matches(tmp_path):
    """A result written by either package reads back the same through both,
    transposed to the reference's [iy, ix] layout, NaNs kept."""
    from types import SimpleNamespace

    rng = np.random.default_rng(3)
    x, y, _, _ = TPr.north_polar_grid(500)
    lon, lat = TQ.grid_lonlat(x, y)
    field = rng.normal(0.2, 0.05, x.shape)
    field[rng.random(x.shape) < 0.3] = np.nan
    res = SimpleNamespace(date="20181205", interp_smth=field, interp_error_smth=np.abs(field) / 10)
    paths = {}
    for name, mod in (("jax", JQ), ("torch", TQ)):
        d = tmp_path / name
        d.mkdir()
        paths[name] = mod.write_result_quicklook(res, lon, lat, 500, str(d))
    assert os.path.basename(paths["torch"]) == os.path.basename(paths["jax"]) \
        == "CS2S3_20181205_500km_quicklook.nc"
    for path in paths.values():
        for read in (JQ.read_quicklook, TQ.read_quicklook):
            q = read(path)
            assert q.date == "20181205"
            np.testing.assert_array_equal(q.radar_freeboard, field.T)
            np.testing.assert_array_equal(q.uncertainty, res.interp_error_smth.T)
            np.testing.assert_array_equal(q.lat, lat.T)
            np.testing.assert_array_equal(q.lon, lon.T)
