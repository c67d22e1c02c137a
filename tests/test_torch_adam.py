"""The optimizer's Adam method and the Adam day, the port against the JAX
package, float64 on the CPU.

``optimize_mll_batch(method="adam")`` runs the same arithmetic as the JAX
package's optax loop (cosine-decayed learning rate, non-finite gradient
entries zeroed): on three cells (one full, one mostly padding, one with a
NaN start), with and without restarts, the log-hypers agree to 1e-9, the
NLL to 1e-10 relative, and iterations and convergence flags are equal
(reached: ~1e-15). The fused objective's CPU twin drives Adam as its plain
path does. The day: ``interpolate_daily`` with Adam (no seed pass, no
cascade, every row fitted from x0 at its bucket's full capacity, then
smoothing and pass 2) on the CLI tests' 250 km season, against the JAX
day, at ``test_torch_daily_two_pass.py``'s tolerances (reached: ~1e-15 m); a wave of
more than one day refuses Adam, as in the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalinterpolation_tpu.models import optimizer as JO
from optimalinterpolation_tpu.pipeline import daily as JD
from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season
from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season
from optimalinterpolation_tpu_torch.models import optimizer as TO
from optimalinterpolation_tpu_torch.pipeline import daily as TD
from optimalinterpolation_tpu_torch.pipeline import multiday as TM

from .test_torch_optimizer import _h0, _padded_cells


def _cells():
    """Three cells: 48 of 64 points, 12 of 64 points, and a NaN start."""
    xs, ys, masks = _padded_cells(range(3))
    xs[1, 12:], ys[1, 12:], masks[1, 12:] = 0.0, 0.0, 0.0
    h0 = _h0(3)
    h0[2] = np.nan
    return h0, xs, ys, masks


@pytest.mark.parametrize("restarts", [1, 2])
def test_adam_batch_matches_jax(restarts):
    h0, xs, ys, masks = _cells()
    kw = dict(method="adam", max_iters=30, jitter=1e-6, backend="xla", restarts=restarts)
    ref = JO.optimize_mll_batch(*map(jnp.asarray, (h0, xs, ys, masks)), JO.OptimizeConfig(**kw))
    got = TO.optimize_mll_batch(*(torch.tensor(a) for a in (h0, xs, ys, masks)),
                                TO.OptimizeConfig(**kw))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(got.log_hypers.numpy(), np.asarray(ref.log_hypers), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.nll.numpy(), np.asarray(ref.nll), rtol=1e-10)
    assert np.isnan(got.log_hypers[2].numpy()).all() and np.isinf(got.nll[2].numpy())
    assert np.abs(got.log_hypers[:2].numpy() - h0[:2]).max() > 0.5  # the steps really move


def test_adam_on_the_fused_twin_matches_its_plain_path():
    h0, xs, ys, masks = _cells()
    args = [torch.tensor(a) for a in (h0, xs, ys, masks)]
    # K3's sizes are multiples of 128: the cells padded to 128 points
    x = torch.zeros(3, 128, 3, dtype=torch.float64)
    y = torch.zeros(3, 128, dtype=torch.float64)
    m = torch.zeros(3, 128, dtype=torch.float64)
    x[:, :64], y[:, :64], m[:, :64] = args[1], args[2], args[3]
    kw = dict(method="adam", max_iters=20, jitter=1e-6)
    fused = TO.optimize_mll_batch(args[0], x, y, m, TO.OptimizeConfig(backend="fused", **kw))
    plain = TO.optimize_mll_batch(args[0], x, y, m, TO.OptimizeConfig(backend="xla", **kw))
    torch.testing.assert_close(fused.log_hypers, plain.log_hypers, rtol=0, atol=1e-9,
                               equal_nan=True)
    torch.testing.assert_close(fused.nll, plain.nll, rtol=1e-9, atol=0)
    assert torch.equal(fused.converged, plain.converged)


def test_chunked_refuses_adam():
    h0, xs, ys, masks = _cells()
    with pytest.raises(ValueError, match="lbfgs"):
        TO.optimize_mll_chunked(*(torch.tensor(a) for a in (h0, xs, ys, masks)),
                                TO.OptimizeConfig(method="adam"), chunk_rows=8)


@pytest.fixture(scope="module")
def season(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("adam_season"))
    make_synthetic_season(d, grid_res_km=250, n_days=9, seed=7, noise_std=0.03,
                          tracks_per_day=(3, 1, 2, 2))
    return read_freeboard_season(d, 250, "2018-2019")


def _adam_day(mod, opt_mod, ds, stats):
    cfg = mod.DailyConfig(dtype="float64", jitter=1e-6, buckets=(64, 128, 256, 512),
                          opt=opt_mod.OptimizeConfig(method="adam", max_iters=5, ftol_abs=1e-3))
    extra = {"device": "cpu"} if mod is TD else {}
    return mod.interpolate_daily(ds, 0, 0.15, cfg, stats=stats, **extra)


def test_adam_day_matches_jax(season):
    jstats, tstats = [], []
    ref = _adam_day(JD, JO, season, jstats).to_reference_dict()
    got = _adam_day(TD, TO, season, tstats).to_reference_dict()
    assert list(got) == list(ref) and len(got) == 15
    for key, r in ref.items():
        g = got[key]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=key)
        if "interp" in key:
            np.testing.assert_allclose(g, r, atol=1e-6, rtol=0, err_msg=key)
        else:  # lZ and the ten hyper fields
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=0, err_msg=key)
    active = np.isfinite(season.sie[:, :, 4])
    assert np.isfinite(got[f"{season.dates[4]}_interp_smth"][active]).all()
    # no seed pass and no cascade: per bucket one Adam fit from x0 and a predict
    stages = [e["stage"] for e in tstats]
    assert "smooth" in stages and not any(s.startswith("seed:") or s == "cascade"
                                          for s in stages)
    fits = [e for e in tstats if e["stage"] == "opt"]
    assert len(fits) == stages.count("predict") > 1
    assert all(e["iters_sum"] == 5 * e["cells"] for e in fits)


def test_adam_wave_of_two_days_raises(season):
    cfg = TD.DailyConfig(dtype="float64", opt=TO.OptimizeConfig(method="adam", max_iters=2))
    with pytest.raises(ValueError, match="lbfgs"):
        TM.interpolate_days(season, [0, 0], [0.15, 0.15], cfg, device="cpu")


def test_adam_season_of_single_day_waves(tmp_path):
    """``run_season`` with Adam in waves of one day (the default) runs every
    window; in waves of two it refuses."""
    from optimalinterpolation_tpu_torch.pipeline.season import SeasonConfig, run_season

    d = str(tmp_path)
    make_synthetic_season(d, grid_res_km=250, n_days=10, seed=7, noise_std=0.03,
                          tracks_per_day=(3, 1, 2, 2))
    ds = read_freeboard_season(d, 250, "2018-2019")
    daily = TD.DailyConfig(dtype="float64", jitter=1e-6, buckets=(64, 128, 256, 512),
                           opt=TO.OptimizeConfig(method="adam", max_iters=3))
    cfg = SeasonConfig(daily=daily, outdir=d, write_quicklook=False)
    with pytest.raises(ValueError, match="lbfgs"):
        run_season(ds, SeasonConfig(daily=daily, outdir=d, write_quicklook=False,
                                    day_parallel=2), days=[0, 1], prior_fn=lambda day: 0.15,
                   device="cpu")
    results = run_season(ds, cfg, days=[0, 1], prior_fn=lambda day: 0.15, device="cpu")
    assert len(results) == 2
    for res in results:
        assert len(res.to_reference_dict()) == 15
        active = np.isfinite(res.hypers["sf2"])
        assert active.sum() > 0 and np.isfinite(res.interp_smth[active]).all()
