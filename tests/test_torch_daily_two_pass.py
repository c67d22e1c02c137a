"""The port's two-pass day against the JAX package, float64 on the CPU.

``interpolate_daily`` of both packages (fit, predict, smoothing, second
predict) runs on the same hand-sized dataset
(tests/reference_flow.make_tiny_dataset) with the same ``DailyConfig``,
once without and once with spatial seeding and the warm-start cascade, at
buckets small enough that the JAX package takes its plain objective:
predictions agree to 1e-6 m, hyper fields to 1e-5 relative (reached:
~1e-12 m and ~1e-10; both packages run the same L-BFGS in the same order),
and the stages, their cells and their iteration sums are equal. Then a
day's hypers as the next run's starts, as a season chains them.
"""

import numpy as np
import pytest

from optimalinterpolation_tpu.models import optimizer as JO
from optimalinterpolation_tpu.pipeline import daily as JD
from optimalinterpolation_tpu_torch.models import optimizer as TO
from optimalinterpolation_tpu_torch.pipeline import daily as TD

from .reference_flow import make_tiny_dataset

_SEEDED = dict(spatial_seed_stride=2, seed_opt_n=32, warmstart_n_seeded=32, warmstart_n=64,
               opt_n_max=64)


def _two_pass(mod, opt_mod, ds, stats, init_hypers=None, **kw):
    cfg = mod.DailyConfig(dtype="float64", jitter=1e-6, buckets=(64, 128, 256),
                          opt=opt_mod.OptimizeConfig(max_iters=15, ftol_abs=1e-3), **kw)
    extra = {"device": "cpu"} if mod is TD else {}
    return mod.interpolate_daily(ds, 0, 0.2, cfg, stats=stats, init_hypers=init_hypers, **extra)


@pytest.mark.parametrize("seeding", [{"spatial_seed_stride": 0}, _SEEDED],
                         ids=["flat", "seeded"])
def test_two_pass_day_matches_jax(seeding):
    ds = make_tiny_dataset()
    jstats, tstats = [], []
    ref = _two_pass(JD, JO, ds, jstats, **seeding).to_reference_dict()
    got = _two_pass(TD, TO, ds, tstats, **seeding).to_reference_dict()
    assert list(got) == list(ref) and len(got) == 15
    for key, r in ref.items():
        g = got[key]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=key)
        if "interp" in key:
            np.testing.assert_allclose(g, r, atol=1e-6, rtol=0, err_msg=key)
        else:  # lZ and the ten hyper fields
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=0, err_msg=key)
    active = np.isfinite(ds.sie[:, :, 4])
    assert np.isfinite(got[f"{ds.dates[4]}_interp_smth"][active]).all()
    fields = ("stage", "n", "cells", "iters_sum")
    assert [[e[f] for f in fields] for e in tstats] == [[e[f] for f in fields] for e in jstats]
    stages = [e["stage"] for e in tstats]
    if seeding is _SEEDED:  # >= 8 seed cells, so the seed pass and the cascade ran
        assert stages == ["seed:opt", "cascade", "opt", "predict", "smooth", "pass2"]
        assert tstats[1]["n"] == 32 and tstats[2]["n"] == 64 and tstats[3]["n"] == 128
    else:
        assert stages == ["opt", "predict", "smooth", "pass2"]
    opt = tstats[stages.index("opt")]
    assert 0 < opt["converged"] <= opt["cells"] and opt["backend"] in ("fused", "xla")


def test_init_hypers_chain_a_day_into_the_next():
    """A day's optimized hypers as the next run's starts, as a season chains
    them: the same result as the JAX package, under half the iterations, no
    seed pass and no cascade; cells without an init take the nearest one's."""
    ds = make_tiny_dataset()
    cold_stats, warm_stats = [], []
    cold = _two_pass(TD, TO, ds, cold_stats, spatial_seed_stride=0)
    init = {k: v.copy() for k, v in cold.hypers.items()}
    ii, jj = np.nonzero(np.isfinite(init["sf2"]))
    for v in init.values():
        v[ii[:5], jj[:5]] = np.nan  # newly active cells
    ref_stats = []
    ref = _two_pass(JD, JO, ds, ref_stats, init_hypers=init, spatial_seed_stride=2)
    warm = _two_pass(TD, TO, ds, warm_stats, init_hypers=init, spatial_seed_stride=2)
    assert [e["stage"] for e in warm_stats] == ["opt", "predict", "smooth", "pass2"]
    assert [(e["stage"], e["iters_sum"]) for e in warm_stats] == [
        (e["stage"], e["iters_sum"]) for e in ref_stats]
    assert warm_stats[0]["iters_sum"] < cold_stats[0]["iters_sum"] / 2
    np.testing.assert_allclose(warm.interp_smth, ref.interp_smth, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="missing"):
        TD.interpolate_daily(ds, 0, 0.2, TD.DailyConfig(dtype="float64"),
                             init_hypers={"sf2": init["sf2"]}, device="cpu")
