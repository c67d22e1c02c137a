"""Waves with per-day prior fields, quicklook waves and quicklook seasons,
through both packages (float64, CPU; setup and tolerances of
``test_torch_multiday.py``).

Inside the port, as ``tests/test_multiday.py`` pins the JAX package:
constant prior fields give exactly the all-scalar wave, and a wave with
precomputed hypers (the quicklook path) gives each day's serial quicklook
field, directly and through ``run_season``. Each also matches the JAX
package's run on the same inputs.
"""

import numpy as np
import pytest

from optimalinterpolation_tpu.pipeline import multiday as JM
from optimalinterpolation_tpu.pipeline import season as JS
from optimalinterpolation_tpu_torch.pipeline import daily as TD
from optimalinterpolation_tpu_torch.pipeline import multiday as TM
from optimalinterpolation_tpu_torch.pipeline import season as TS

from .test_multiday import wave_season  # noqa: F401  (module-scoped fixture)
from .test_torch_multiday import assert_matches_jax, assert_same_days, stage_entries, wave_cfg
from .test_torch_season_waves import run_unchained


def quicklook_hypers(g: int) -> dict:
    """tests/test_multiday.py's precomputed fields."""
    return {"ell_x": np.full((g, g), 300e3), "ell_y": np.full((g, g), 300e3),
            "ell_t": np.full((g, g), 2.0), "sf2": np.full((g, g), 0.05),
            "sn2": np.full((g, g), 0.01)}


def test_wave_prior_fields_match_scalars(wave_season):  # noqa: F811
    """Per-day priors may mix scalars and (G, G) fields; constant fields
    give the all-scalar wave exactly."""
    ds = wave_season[0]
    days = [0, 2]
    base = TM.interpolate_days(ds, days, [0.15, 0.18], wave_cfg("torch"), device="cpu")
    fields = [np.full(ds.sie.shape[:2], 0.15), 0.18]
    tstats, jstats = [], []
    got = TM.interpolate_days(ds, days, fields, wave_cfg("torch"), stats=tstats, device="cpu")
    for b, g in zip(base, got):
        for name in ("interp", "interp_smth"):
            np.testing.assert_array_equal(getattr(g, name), getattr(b, name), err_msg=name)
    ref = JM.interpolate_days(ds, days, fields, wave_cfg("jax"), stats=jstats)
    assert_matches_jax(got, ref)
    assert stage_entries(tstats) == stage_entries(jstats)


@pytest.mark.parametrize("days", [[0, 2], [1]])
def test_wave_precomputed_hypers_matches_serial_quicklook(wave_season, days):  # noqa: F811
    """A quicklook wave is one combined predict: each day as its serial
    quicklook field, the unsmoothed outputs equal to the predictions, the
    hyper fields the given ones; and as the JAX package's quicklook wave."""
    ds = wave_season[0]
    pre = quicklook_hypers(ds.sie.shape[0])
    serial = [TD.interpolate_daily(ds, d, 0.15, wave_cfg("torch"), precomputed_hypers=pre,
                                   device="cpu") for d in days]
    tstats, jstats = [], []
    wave = TM.interpolate_days(ds, days, [0.15] * len(days), wave_cfg("torch"),
                               precomputed_hypers=pre, stats=tstats, device="cpu")
    assert_same_days(wave, serial, ("interp_smth", "interp_error_smth", "lZ"))
    for w in wave:
        np.testing.assert_array_equal(w.interp, w.interp_smth)
        for name in w.hypers:
            np.testing.assert_allclose(w.hypers[name], pre[name])
    ref = JM.interpolate_days(ds, days, [0.15] * len(days), wave_cfg("jax"),
                              precomputed_hypers=pre, stats=jstats)
    assert_matches_jax(wave, ref)
    assert stage_entries(tstats) == stage_entries(jstats)
    assert {e["stage"] for e in tstats} == {"pass2"}


@pytest.mark.parametrize("day_parallel", [1, 2])
def test_run_season_with_precomputed_hypers(wave_season, tmp_path, day_parallel):  # noqa: F811
    """With precomputed hypers each wave is one combined predict: the same
    fields as the serial quicklook season, and as the JAX package's."""
    ds = wave_season[0]
    pre = quicklook_hypers(ds.sie.shape[0])
    days = [0, 1, 2]
    serial = run_unchained(TS, ds, tmp_path / "serial", days, 1, precomputed_hypers=pre)
    got = run_unchained(TS, ds, tmp_path / "waved", days, day_parallel, precomputed_hypers=pre)
    assert_same_days(got, serial, ("interp_smth", "interp_error_smth", "lZ"))
    for r in got:
        np.testing.assert_array_equal(r.interp, r.interp_smth)
    ref = run_unchained(JS, ds, tmp_path / "jax", days, day_parallel, precomputed_hypers=pre)
    assert_matches_jax(got, ref)
