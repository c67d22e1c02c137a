"""A season without chaining, in waves and serially, through both packages
(float64, CPU; setup and tolerances of ``test_torch_multiday.py``).

Inside the port, as ``tests/test_multiday.py`` pins the JAX package:
``run_season(day_parallel=2)`` writes what waves of one day (the default,
day by day) write. Against
the JAX package: its ``run_season`` on the same days, run as one wave of four
days (without chaining or shuffling, a day's result does not depend on the
days beside it). Quicklook seasons are in ``test_torch_multiday_paths.py``.
"""

import os

from optimalinterpolation_tpu.pipeline import season as JS
from optimalinterpolation_tpu_torch.pipeline import season as TS

from .test_multiday import wave_season  # noqa: F401  (module-scoped fixture)
from .test_torch_multiday import assert_matches_jax, assert_same_days, wave_cfg


def run_unchained(mod, ds, outdir, days, day_parallel, precomputed_hypers=None):
    """``mod.run_season`` (either package's season module) with chaining
    off, no NetCDFs, prior 0.15."""
    extra = {"device": "cpu"} if mod is TS else {}
    cfg = mod.SeasonConfig(daily=wave_cfg("jax" if mod is JS else "torch"), outdir=str(outdir),
                           write_quicklook=False, chain_warmstart=False,
                           day_parallel=day_parallel)
    return mod.run_season(ds, cfg, days=days, prior_fn=lambda d: 0.15,
                          precomputed_hypers=precomputed_hypers, log=lambda s: None, **extra)


def test_run_season_waves_matches_serial(wave_season, tmp_path):  # noqa: F811
    ds = wave_season[0]
    days = [0, 1, 2, 3]
    serial = run_unchained(TS, ds, tmp_path / "serial", days, 1)
    waved = run_unchained(TS, ds, tmp_path / "waved", days, 2)
    assert_same_days(waved, serial, ("interp_smth",))
    assert sorted(os.listdir(tmp_path / "waved")) == sorted(os.listdir(tmp_path / "serial"))
    ref = run_unchained(JS, ds, tmp_path / "jax", days, 4)
    assert_matches_jax(waved, ref)
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "waved"))
