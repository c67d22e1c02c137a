"""The port's copies of the regrid, prior, validation and stage-timer code
against the JAX package's, on seeded inputs: every array and number equal.

``bilinear_regrid`` and ``regrid_field`` (fill on and off; the footprint
mask and the built-in ocean mask), ``load_ocean_mask`` native and resampled
(the port's ``.npz`` byte-equal to the JAX package's), ``background_prior``,
``validate_fields`` / ``ValidationStats.to_dict`` and ``StageTimer``.
"""

import math
import os

import numpy as np
import pytest

from optimalinterpolation_tpu import validation as JV
from optimalinterpolation_tpu.data import prior as JP
from optimalinterpolation_tpu.data import regrid as JG
from optimalinterpolation_tpu.utils import profiling as JPf
from optimalinterpolation_tpu_torch import validation as TV
from optimalinterpolation_tpu_torch.data import prior as TP
from optimalinterpolation_tpu_torch.data import regrid as TG
from optimalinterpolation_tpu_torch.utils import profiling as TPf


def _axes(res_km):
    """Cell centres of the polar-stereographic grid, as the ocean mask's."""
    n = int(8e6 / (res_km * 1e3))
    return -4e6 + (np.arange(n) + 0.5) * (8e6 / n)


def _field(rng, n, holes=0.3):
    f = np.cumsum(rng.normal(size=(n, n)), axis=0) * 0.01 + 0.2
    f[rng.random((n, n)) < holes] = np.nan
    f[: n // 5] = np.nan  # a large hole the fill must reach across
    return f


@pytest.mark.parametrize("grids", [(200, 100), (100, 250), (250, 250)])
def test_bilinear_regrid_matches_jax(grids):
    rng = np.random.default_rng(sum(grids))
    sx, dx = _axes(grids[0]), _axes(grids[1])
    src = _field(rng, sx.size)
    got = TG.bilinear_regrid(src, sx, sx, dx, dx)
    np.testing.assert_array_equal(got, JG.bilinear_regrid(src, sx, sx, dx, dx))
    gx, gy = np.meshgrid(dx, dx)  # 2-D destination coordinates
    np.testing.assert_array_equal(TG.bilinear_regrid(src, sx, sx, gx, gy),
                                  JG.bilinear_regrid(src, sx, sx, gx, gy))
    assert np.isfinite(got).any() and np.isnan(got).any()


@pytest.mark.parametrize("fill", [True, False])
@pytest.mark.parametrize("mask", ["footprint", "builtin", "array"])
def test_regrid_field_matches_jax(fill, mask):
    rng = np.random.default_rng(7)
    sx, dx = _axes(50), _axes(25)
    src = _field(rng, sx.size, holes=0.1)
    ocean = {"footprint": None, "builtin": "builtin",
             "array": rng.random((dx.size, dx.size)) < 0.6}[mask]
    got = TG.regrid_field(src, sx, sx, dx, dx, fill=fill, ocean_mask=ocean)
    ref = JG.regrid_field(src, sx, sx, dx, dx, fill=fill, ocean_mask=ocean)
    assert got.shape == (320, 320) and np.isfinite(got).sum() > 1000
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="unknown ocean_mask"):
        TG.regrid_field(src, sx, sx, dx, dx, ocean_mask="coastlines")


def test_ocean_mask_copy_and_resampling_match_jax():
    copies = [os.path.join(os.path.dirname(m.__file__), "static", "ocean_mask_25km.npz")
              for m in (TG, JG)]
    with open(copies[0], "rb") as a, open(copies[1], "rb") as b:
        assert a.read() == b.read()
    for got, ref in zip(TG.load_ocean_mask(), JG.load_ocean_mask()):
        np.testing.assert_array_equal(got, ref)
    mask, _, _ = TG.load_ocean_mask()
    assert mask.shape == (320, 320) and mask.dtype == bool and 0 < mask.mean() < 1
    for res in (50, 12.5):
        d = _axes(res)
        for args in ((d, d), np.meshgrid(d, d)):
            for got, ref in zip(TG.load_ocean_mask(*args), JG.load_ocean_mask(*args)):
                np.testing.assert_array_equal(got, ref)


def test_background_prior_matches_jax():
    rng = np.random.default_rng(9)
    g, s, t = 24, 4, 40
    obs = rng.normal(0.2, 0.1, (g, g, s, t))
    obs[rng.random(obs.shape) < 0.8] = np.nan
    obs[:3, :3] = np.nan  # never observed: the pole hole below and a corner
    lat = np.linspace(60, 90, g)[:, None] * np.ones((1, g))
    lat[:3, :3] = 89.0
    for n_days in (9, 31):
        got = TP.background_prior(obs, lat, n_days=n_days)
        np.testing.assert_array_equal(got, JP.background_prior(obs, lat, n_days=n_days))
        assert np.isfinite(got[:3, :3]).all()  # filled from the valid pole cells
    lat[:] = 70.0  # no pole cell: the hole stays NaN
    got = TP.background_prior(obs, lat, n_days=9)
    np.testing.assert_array_equal(got, JP.background_prior(obs, lat, n_days=9))
    assert np.isnan(got[:3, :3]).all()


def _same_stats(got, ref):
    a, b = got.to_dict(), ref.to_dict()
    assert list(a) == list(b) == ["n", "bias", "rmse", "corr", "coverage", "mean_z"]
    for k in a:
        assert (math.isnan(a[k]) and math.isnan(b[k])) or a[k] == b[k], k


def test_validate_fields_matches_jax():
    rng = np.random.default_rng(11)
    axis = _axes(100)
    dates = ["20181205", "20181206", "20181207"]
    fields = {d: _field(rng, axis.size, holes=0.2) for d in dates}
    sig = {d: np.abs(rng.normal(0.02, 0.01, (axis.size,) * 2)) for d in dates}
    n = 3000
    pts = dict(x=rng.uniform(-4.2e6, 4.2e6, n), y=rng.uniform(-4e6, 4e6, n),
               date=rng.choice(dates + ["20190101"], n), value=rng.normal(0.2, 0.05, n))
    tobs, jobs = TV.PointObs(**pts), JV.PointObs(**pts)
    got = TV.validate_fields(tobs, fields, axis, axis, uncertainties=sig)
    _same_stats(got, JV.validate_fields(jobs, fields, axis, axis, uncertainties=sig))
    assert got.n > 100 and 0 < got.coverage < 1 and np.isfinite(got.mean_z)
    _same_stats(TV.validate_fields(tobs, fields, axis, axis),
                JV.validate_fields(jobs, fields, axis, axis))
    empty = {"20200101": fields[dates[0]]}  # no point on that date
    _same_stats(TV.validate_fields(tobs, empty, axis, axis),
                JV.validate_fields(jobs, empty, axis, axis))
    for date in dates:
        for a, b in zip(TV.colocate(tobs, fields[date], axis, axis, date),
                        JV.colocate(jobs, fields[date], axis, axis, date)):
            np.testing.assert_array_equal(a, b)


def test_stage_timer_matches_jax(monkeypatch):
    """The same stages on a scripted clock give the same summary and log."""
    summaries, logs = [], []
    for mod in (TPf, JPf):
        ticks = iter([0.0, 1.5, 2.0, 2.25, 3.0, 7.0])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        log = []
        t = mod.StageTimer(log=log.append)
        with t.stage("optimize", items=300):
            pass
        with t.stage("predict"):
            pass
        with pytest.raises(KeyError):
            with t.stage("optimize", items=100):
                raise KeyError("the stage is timed when its block raises")
        summaries.append(t.summary())
        logs.append(log)
    assert summaries[0] == summaries[1]
    assert logs[0] == logs[1] == ["[optimize] 1.50s (200.0/s)", "[predict] 0.25s",
                                  "[optimize] 4.00s (25.0/s)"]
    assert summaries[0]["optimize"] == {"seconds": 5.5, "calls": 2, "items": 400,
                                        "rate": 72.73}
