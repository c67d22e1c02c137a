"""The port's default season: chained, one day a wave (``day_parallel`` 1),
resumed, against the JAX package's serial ``run_season`` (float64, CPU;
setup and tolerances of ``test_torch_multiday.py``).

The JAX package's serial season over windows 0 and 1 is the reference.
The port runs window 0 cold and window 1 from window 0's fitted hypers, and
a second run skips both. (A chain read back from the JAX package's pickles
is in ``test_torch_season.py``: at any width a season takes one code
path.)
"""

import os
import sys

import pytest
import torch

from optimalinterpolation_tpu.pipeline import season as JS
from optimalinterpolation_tpu_torch.io.pickles import load_pickle
from optimalinterpolation_tpu_torch.pipeline import season as TS

from .test_multiday import wave_season  # noqa: F401  (module-scoped fixture)
from .test_torch_multiday import assert_matches_jax, wave_cfg
from .test_torch_season import pickles

torch.set_num_threads(2)

DAYS = [0, 1]


def serial_cfg(pkg: str, outdir, **kw):
    mod = JS if pkg == "jax" else TS
    return mod.SeasonConfig(daily=wave_cfg(pkg), outdir=str(outdir), write_quicklook=False,
                            **kw)


@pytest.fixture(scope="module")
def jax_serial(wave_season, tmp_path_factory):  # noqa: F811
    """The JAX package's chained serial season over windows 0 and 1, and
    its outdir."""
    out = tmp_path_factory.mktemp("jax_serial")
    res = JS.run_season(wave_season[0], serial_cfg("jax", out), days=DAYS,
                        prior_fn=lambda d: 0.15, log=lambda s: None)
    return res, out


def test_serial_season_chains_and_resumes(wave_season, jax_serial, tmp_path):  # noqa: F811
    ds = wave_season[0]
    ref, jax_out = jax_serial
    assert TS.SeasonConfig().day_parallel == 1 and TS.SeasonConfig().resume
    cfg = serial_cfg("torch", tmp_path)
    lines = []
    got = TS.run_season(ds, cfg, days=DAYS, prior_fn=lambda d: 0.15, log=lines.append,
                        device="cpu")
    assert [line.split(":")[0] for line in lines] == ["[season] wave 1/2 (1 days)",
                                                      "[season] wave 2/2 (1 days)"]
    assert_matches_jax(got, ref)
    assert pickles(tmp_path) == pickles(jax_out)
    assert_matches_jax([load_pickle(os.path.join(tmp_path, f)) for f in pickles(tmp_path)],
                       got)
    lines.clear()
    again = TS.run_season(ds, cfg, days=DAYS, prior_fn=lambda d: 0.15, log=lines.append,
                          device="cpu")
    assert again == [] and len(lines) == 2 and all("skipping (resume)" in s for s in lines)


def test_season_without_h5py_fails_before_the_first_day(wave_season, tmp_path,  # noqa: F811
                                                         monkeypatch):
    """Quicklook NetCDFs need h5py: without it the season stops before any
    day is fitted, and writes nothing."""
    monkeypatch.setitem(sys.modules, "h5py", None)  # ``import h5py`` raises ImportError

    def never(*args, **kwargs):
        raise AssertionError("a day ran")

    monkeypatch.setattr(TS, "interpolate_days", never)
    cfg = TS.SeasonConfig(daily=wave_cfg("torch"), outdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="h5py"):
        TS.run_season(wave_season[0], cfg, days=DAYS, prior_fn=lambda d: 0.15,
                      log=lambda s: None, device="cpu")
    assert os.listdir(tmp_path) == []
