"""The port's default season: chained, one day a wave (``day_parallel`` 1),
resumed, against the JAX package's serial ``run_season`` (float64, CPU;
setup and tolerances of ``test_torch_multiday.py``).

The JAX package's serial season over windows 0 and 1 is the reference.
The port runs window 0 cold and window 1 from window 0's fitted hypers,
with h5py blocked, and writes each day's pickle and quicklook NetCDF; a
second run skips both days. (A chain read back from the JAX package's pickles
is in ``test_torch_season.py``: at any width a season takes one code
path.)
"""

import os
import sys

import numpy as np
import pytest

from optimalinterpolation_tpu.io import quicklook as JQ
from optimalinterpolation_tpu.pipeline import season as JS
from optimalinterpolation_tpu_torch.io import quicklook as TQ
from optimalinterpolation_tpu_torch.io.pickles import load_pickle
from optimalinterpolation_tpu_torch.pipeline import season as TS

from .test_multiday import wave_season  # noqa: F401  (module-scoped fixture)
from .test_torch_multiday import assert_matches_jax, wave_cfg
from .test_torch_season import pickles

DAYS = [0, 1]


@pytest.fixture(scope="module")
def jax_serial(wave_season, tmp_path_factory):  # noqa: F811
    """The JAX package's chained serial season over windows 0 and 1, and
    its outdir."""
    out = tmp_path_factory.mktemp("jax_serial")
    cfg = JS.SeasonConfig(daily=wave_cfg("jax"), outdir=str(out), write_quicklook=False)
    res = JS.run_season(wave_season[0], cfg, days=DAYS,
                        prior_fn=lambda d: 0.15, log=lambda s: None)
    return res, out


@pytest.fixture(scope="module")
def torch_serial(wave_season, tmp_path_factory):  # noqa: F811
    """The port's serial season over windows 0 and 1 at the default
    ``SeasonConfig`` (pickles and quicklook NetCDFs), run with h5py blocked:
    its results, log lines, config and outdir."""
    out = tmp_path_factory.mktemp("torch_serial")
    cfg = TS.SeasonConfig(daily=wave_cfg("torch"), outdir=str(out))
    lines = []
    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "h5py", None)  # ``import h5py`` raises ImportError
        got = TS.run_season(wave_season[0], cfg, days=DAYS, prior_fn=lambda d: 0.15,
                            log=lines.append, device="cpu")
    return got, lines, cfg, out


def test_serial_season_chains_and_resumes(wave_season, jax_serial, torch_serial):  # noqa: F811
    ds = wave_season[0]
    ref, jax_out = jax_serial
    got, lines, cfg, out = torch_serial
    assert TS.SeasonConfig().day_parallel == 1 and TS.SeasonConfig().resume
    assert [line.split(":")[0] for line in lines] == ["[season] wave 1/2 (1 days)",
                                                      "[season] wave 2/2 (1 days)"]
    assert_matches_jax(got, ref)
    assert pickles(out) == pickles(jax_out)
    assert_matches_jax([load_pickle(os.path.join(out, f)) for f in pickles(out)], got)
    lines = []
    again = TS.run_season(ds, cfg, days=DAYS, prior_fn=lambda d: 0.15, log=lines.append,
                          device="cpu")
    assert again == [] and len(lines) == 2 and all("skipping (resume)" in s for s in lines)


def test_season_without_h5py_writes_its_netcdfs(wave_season, torch_serial):  # noqa: F811
    """With h5py blocked the season writes each day's pickle and quicklook
    NetCDF (``io/hdf5.py``), and the JAX package's reader gives the pickle's
    smoothed fields transposed, bit for bit with NaNs in place."""
    ds = wave_season[0]
    got, _, _, out = torch_serial
    assert len(got) == len(DAYS)
    lon, lat = TQ.grid_lonlat(ds.x, ds.y)
    for res in got:
        stem = os.path.join(out, f"CS2S3_{res.date}_{ds.grid_res_km}km")
        ref = load_pickle(stem + ".pkl")
        q = JQ.read_quicklook(stem + "_quicklook.nc")
        assert q.date == res.date and np.isnan(q.radar_freeboard).any()
        for a, b in ((q.radar_freeboard, ref[f"{res.date}_interp_smth"].T),
                     (q.uncertainty, ref[f"{res.date}_interp_error_smth"].T),
                     (q.lat, lat.T), (q.lon, lon.T)):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint64),
                                          np.ascontiguousarray(b, np.float64).view(np.uint64))
