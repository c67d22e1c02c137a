"""The port's waves (``pipeline.multiday``) against its own days and against
the JAX package, float64 on the CPU.

Setup of ``tests/test_multiday.py``: its ``wave_season`` (125 km, 12 days,
active set thinned to every 4th cell) and its ``_CFG`` (buckets (128, 256),
10 L-BFGS iterations, no seeding, no cascade), built here for both
packages. Inside the port, a wave gives each day what ``interpolate_daily``
gives it, at the JAX test's own tolerances (1e-8 relative and 1e-10 m).
Against the JAX package: all 15 reference-dict fields with identical NaN
masks, predictions within 1e-6 m, lZ and hypers within 1e-5 relative (as
``tests/test_torch_daily_two_pass.py`` holds the day), and the same stage entries
(names, N, cells and iteration sums). Other wave cases are in
``test_torch_multiday_paths.py`` and ``test_torch_multiday_seeded.py``,
which take their helpers from here; each file runs in well under a minute.
"""

import numpy as np
import pytest
import torch

from optimalinterpolation_tpu.models import optimizer as JO
from optimalinterpolation_tpu.pipeline import daily as JD
from optimalinterpolation_tpu.pipeline import multiday as JM
from optimalinterpolation_tpu_torch.models import optimizer as TO
from optimalinterpolation_tpu_torch.pipeline import daily as TD
from optimalinterpolation_tpu_torch.pipeline import multiday as TM

from .test_multiday import wave_season  # noqa: F401  (module-scoped fixture)

PACKAGES = {"jax": (JD, JO), "torch": (TD, TO)}


def wave_cfg(pkg: str, **kw):
    """``tests/test_multiday.py::_CFG`` in either package, with ``kw``
    replacing fields."""
    mod, opt_mod = PACKAGES[pkg]
    fields = dict(window_days=9, radius_km=450.0, buckets=(128, 256), dtype="float64",
                  warmstart_n=0, spatial_seed_stride=0,
                  opt=opt_mod.OptimizeConfig(max_iters=10, nystroem_min_n=0))
    fields.update(kw)
    return mod.DailyConfig(**fields)


def stage_entries(stats):
    return [(e["stage"], e["n"], e["cells"], e["iters_sum"]) for e in stats]


def assert_matches_jax(got, ref):
    """Port results against JAX results (lists of DailyResult, or of
    reference dicts): dates, the 15 keys, NaN masks, values."""
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        g = g if isinstance(g, dict) else g.to_reference_dict()
        r = r if isinstance(r, dict) else r.to_reference_dict()
        assert list(g) == list(r) and len(g) == 15
        for key, rv in r.items():
            gv = np.asarray(g[key])
            np.testing.assert_array_equal(np.isnan(gv), np.isnan(rv), err_msg=key)
            if key.endswith(("_interp", "_interp_error", "_interp_smth", "_interp_error_smth")):
                np.testing.assert_allclose(gv, rv, atol=1e-6, rtol=0, err_msg=key)
            else:  # lZ and the ten hyper fields
                np.testing.assert_allclose(gv, rv, rtol=1e-5, atol=0, err_msg=key)


def assert_same_days(got, ref, fields=("interp", "interp_smth", "interp_error_smth")):
    """Two runs of the port, at tests/test_multiday.py's tolerances."""
    assert [r.date for r in got] == [r.date for r in ref]
    for g, r in zip(got, ref):
        for name in fields:
            np.testing.assert_allclose(getattr(g, name), getattr(r, name), rtol=1e-8,
                                       atol=1e-10, equal_nan=True, err_msg=name)


def test_wave_matches_serial_days(wave_season):  # noqa: F811
    ds = wave_season[0]
    days = [0, 1, 2]
    serial = [TD.interpolate_daily(ds, d, 0.15, wave_cfg("torch"), device="cpu") for d in days]
    tstats, jstats = [], []
    wave = TM.interpolate_days(ds, days, [0.15] * 3, wave_cfg("torch"), stats=tstats,
                               device="cpu")
    assert_same_days(wave, serial)
    for w, s in zip(wave, serial):
        for name in w.hypers:
            np.testing.assert_allclose(w.hypers[name], s.hypers[name], rtol=1e-7,
                                       equal_nan=True)
    assert {"opt", "predict", "smooth", "pass2"} <= {e["stage"] for e in tstats}

    ref = JM.interpolate_days(ds, days, [0.15] * 3, wave_cfg("jax"), stats=jstats)
    assert_matches_jax(wave, ref)
    assert stage_entries(tstats) == stage_entries(jstats)
    # one combined bucket per capacity: each stage covers the three days
    assert sum(e["cells"] for e in tstats if e["stage"] == "pass2") >= sum(
        int(np.isfinite(ds.sie[:, :, d + 4]).sum()) for d in days)


def test_wave_needs_the_card_unless_asked_for_the_cpu(wave_season):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda|nvidia"):
        TM.interpolate_days(wave_season[0], [0], [0.15], wave_cfg("torch"))
