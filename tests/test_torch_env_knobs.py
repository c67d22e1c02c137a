"""The JAX package's environment knobs in the port, read after import.

``OI_BUCKET_128``, ``OI_BUCKET_256``, ``OI_OPT_N_MAX``,
``OI_CASCADE_SKIP_TOL``, ``OI_SEG_SCHEDULE`` and ``OI_CASCADE_NYS_M`` are
read when a config is built or a function called, never at import (the JAX
package's ``tests/test_env_knobs.py``, whose six tests are ported first).
Every test sets its knobs with ``monkeypatch.setenv`` after both packages
are imported. Then each knob's two-pass day, float64 on the CPU, against
the JAX package's under the same knob (``check_knob_day``): the stages,
their cells, iteration sums and Nystrom ranks equal, predictions within
1e-6 m and the other fields within 1e-5 relative (the tolerances of
``tests/test_torch_daily_two_pass.py::test_two_pass_day_matches_jax``).
Its cases run in ``test_torch_knob_days.py``, ``test_torch_knob_days_cascade.py``
and ``test_torch_knob_days_nystroem.py``, a file a topic, so that xdist's
``--dist loadfile`` gives them to different workers. Last, the North-star
day's subsample and score (``tools/north_star.py``) against ``bench.py``'s
formulas, written out here.
"""

import numpy as np
import pytest

from optimalinterpolation_tpu.data import neighbors as JN
from optimalinterpolation_tpu.models import optimizer as JO
from optimalinterpolation_tpu.pipeline import daily as JD
from optimalinterpolation_tpu_torch.data import neighbors as TN
from optimalinterpolation_tpu_torch.data.window import TrainingVectors
from optimalinterpolation_tpu_torch.models import optimizer as TO
from optimalinterpolation_tpu_torch.pipeline import daily as TD
from optimalinterpolation_tpu_torch.pipeline.season import SeasonConfig
from tools import north_star

from .reference_flow import make_tiny_dataset

KNOBS = ("OI_BUCKET_128", "OI_BUCKET_256", "OI_OPT_N_MAX", "OI_CASCADE_SKIP_TOL",
         "OI_SEG_SCHEDULE", "OI_CASCADE_NYS_M", "OI_NYSTROEM_MIN_N", "OI_BLOCKED_MIN_N")


@pytest.fixture(autouse=True)
def _unset(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


# ---- the JAX package's tests/test_env_knobs.py, against the port ----------


def test_opt_n_max_env_after_import(monkeypatch):
    assert TD.DailyConfig().opt_n_max == 1024
    monkeypatch.setenv("OI_OPT_N_MAX", "512")
    assert TD.DailyConfig().opt_n_max == 512
    assert TD.DailyConfig(opt_n_max=0).opt_n_max == 0  # an explicit value wins


def test_cascade_skip_tol_env_after_import(monkeypatch):
    assert TD.DailyConfig().cascade_skip_tol == 0.05
    monkeypatch.setenv("OI_CASCADE_SKIP_TOL", "0.0")
    assert TD.DailyConfig().cascade_skip_tol == 0.0
    assert TD.DailyConfig(cascade_skip_tol=0.5).cascade_skip_tol == 0.5


def test_bucket_env_after_import(monkeypatch):
    assert TN.default_buckets() == TN.DEFAULT_BUCKETS == JN.DEFAULT_BUCKETS
    assert tuple(TD.DailyConfig().buckets) == (512, 1024, 2048, 4096)
    monkeypatch.setenv("OI_BUCKET_128", "1")
    monkeypatch.setenv("OI_BUCKET_256", "1")
    assert TN.default_buckets() == JN.default_buckets() == (128, 256, 512, 1024, 2048, 4096)
    assert tuple(TD.DailyConfig().buckets) == (128, 256, 512, 1024, 2048, 4096)
    assert tuple(TD.DailyConfig(buckets=(512,)).buckets) == (512,)


def test_seg_schedule_env_after_import(monkeypatch):
    assert TO._seg_schedule() == JO._seg_schedule() == (1, 4)
    monkeypatch.setenv("OI_SEG_SCHEDULE", "2,8,16")
    assert TO._seg_schedule() == JO._seg_schedule() == (2, 8, 16)


def test_cascade_nys_m_env_after_import(monkeypatch):
    assert TD._cascade_nys_m() == 0
    monkeypatch.setenv("OI_CASCADE_NYS_M", "256")
    assert TD._cascade_nys_m() == JD._cascade_nys_m() == 256


@pytest.mark.parametrize("gather", ["gather_neighborhoods", "_gather_plain"])
def test_gather_neighborhoods_default_buckets_resolve_at_call(monkeypatch, gather):
    rng = np.random.default_rng(0)
    n = 200
    xyt = np.column_stack([rng.uniform(0, 1e5, n), rng.uniform(0, 1e5, n), rng.uniform(0, 9, n)])
    train = TrainingVectors(x=xyt[:, 0], y=xyt[:, 1], t=xyt[:, 2], z=rng.normal(size=n))
    cells = np.array([[5e4, 5e4]])
    monkeypatch.setenv("OI_BUCKET_128", "1")
    batches = getattr(TN, gather)(train, cells, t_star=4.0, radius_m=3e4, batch_multiple=1)
    # ~56 neighbors: the 128 bucket, which exists only through the knob
    assert [b.capacity for b in batches] == [128]


def test_entry_points_build_their_config_at_call(monkeypatch):
    """A knob set after import reaches ``interpolate_daily`` called without
    a config (here the quicklook day) and a ``SeasonConfig`` built after
    it."""
    monkeypatch.setenv("OI_OPT_N_MAX", "256")
    assert SeasonConfig().daily.opt_n_max == 256
    monkeypatch.setenv("OI_BUCKET_128", "1")
    ds = make_tiny_dataset()  # 72-109 neighbours a cell
    g = ds.x.shape[0]
    hyp = {k: np.full((g, g), v) for k, v in zip(TD.HYPER_NAMES, (2.5e5, 2.5e5, 2.0, 4e-3, 4e-4))}
    stats = []
    TD.interpolate_daily(ds, 0, 0.2, precomputed_hypers=hyp, stats=stats, device="cpu")
    assert [(e["stage"], e["n"]) for e in stats] == [("pass2", 128)]


# ---- each knob's day against the JAX package's ----------------------------

# seed pass at 32 points, cascade stages at 16 and 32, fine stage at 64 (set
# by the case's knob or value)
_SEEDED = dict(buckets=(64, 128, 256), spatial_seed_stride=2, seed_opt_n=32,
               warmstart_n_seeded=16, warmstart_n=64)
# cells with 282-346 neighbours (coverage 0.3): the 512 bucket, fitted on a
# 288-point subsample after a cold cascade stage at 256
_NYS = dict(spatial_seed_stride=0, warmstart_n=256, opt_n_max=288)

# case: (knobs, make_tiny_dataset's coverage and active radius, DailyConfig
# fields, L-BFGS iterations)
CASES = {
    "buckets": ({"OI_BUCKET_128": "1", "OI_BUCKET_256": "1"}, 0.08, 4.0,
                dict(spatial_seed_stride=0), 15),
    "opt_n_max": ({"OI_OPT_N_MAX": "64"}, 0.08, 4.0, _SEEDED, 15),
    "seg_schedule": ({"OI_SEG_SCHEDULE": "2,8"}, 0.08, 4.0, dict(_SEEDED, opt_n_max=64), 15),
    "skip_tol": ({"OI_CASCADE_SKIP_TOL": "0"}, 0.08, 4.0, dict(_SEEDED, opt_n_max=64), 15),
    "cascade_nys_m": ({"OI_CASCADE_NYS_M": "128"}, 0.3, 3.2, _NYS, 3),
    # OI_NYSTROEM_MIN_N is read before the override's nystroem_min_n, so the
    # override routes nothing (optimizer.py:186-188): inert in both packages
    "nys_m_under_nystroem_min_n": ({"OI_CASCADE_NYS_M": "128", "OI_NYSTROEM_MIN_N": "4096"},
                                   0.3, 3.2, _NYS, 3),
}


def _day(mod, opt_mod, ds, kw, max_iters):
    """The two-pass day of ``mod``; the config is built here, after the
    knobs are set, with no value for the knob under test."""
    cfg = mod.DailyConfig(dtype="float64", jitter=1e-6,
                          opt=opt_mod.OptimizeConfig(max_iters=max_iters, ftol_abs=1e-3), **kw)
    stats = []
    extra = {"device": "cpu"} if mod is TD else {}
    res = mod.interpolate_daily(ds, 0, 0.2, cfg, stats=stats, **extra)
    return res.to_reference_dict(), stats


def check_knob_day(monkeypatch, case):
    """The port's day under ``CASES[case]`` against the JAX package's (see
    the module docstring); the cases run in ``test_torch_knob_days*.py``."""
    env, coverage, radius, kw, max_iters = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    segs = []
    segment = TO._lbfgs_segment

    def spy(value_fn, vg_fn, st, knobs, seg_iters, pair=None):
        segs.append(seg_iters)
        return segment(value_fn, vg_fn, st, knobs, seg_iters, pair)

    spy.host_syncs = 0
    monkeypatch.setattr(TO, "_lbfgs_segment", spy)
    ds = make_tiny_dataset(coverage=coverage, active_radius_cells=radius)
    ref, jstats = _day(JD, JO, ds, kw, max_iters)
    got, tstats = _day(TD, TO, ds, kw, max_iters)

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
    # the objective: JAX's entries carry the Nystrom rank "m" alone
    assert [e.get("m") for e in tstats] == [e.get("m") for e in jstats]

    # what the knob changed, in the port's own entries
    by = [(e["stage"], e["n"]) for e in tstats]
    fits = [e for e in tstats if e["stage"].endswith(("cascade", "opt"))]
    if case == "buckets":  # 72-109 neighbours a cell: the 128 bucket, not 512
        assert by == [("opt", 128), ("predict", 128), ("smooth", 24), ("pass2", 128)]
    elif case == "opt_n_max":
        assert [e["n"] for e in tstats if e["stage"] == "opt"] == [64]
    elif case == "seg_schedule":
        assert segs[:2] == [2, 8]  # the seed pass: one chunk, cold, the schedule's sweeps first
    elif case == "skip_tol":
        cascade = [e for e in tstats if e["stage"] == "cascade"]
        assert [e["n"] for e in cascade] == [16, 32]
        assert cascade[0]["cells"] == cascade[1]["cells"] == 56  # nothing drained (0.05: 49)
    elif case == "cascade_nys_m":
        assert [(e["stage"], e["n"], e["backend"], e.get("m")) for e in fits] == [
            ("cascade", 256, "nystroem", 128), ("opt", 288, "xla", None)]
    else:  # the override is inert: the stage stays on K3 (its twin here)
        assert [(e["stage"], e["n"], e["backend"]) for e in fits] == [
            ("cascade", 256, "fused"), ("opt", 288, "xla")]


# ---- the North-star day's subsample and score -----------------------------


def test_north_star_subsample_is_bench_py_mask():
    """``north_star.subsample`` drops the cells ``bench.py:393-400``
    drops: ``default_rng(seed).random(sie.shape[:2]) > scale`` -> NaN."""
    rng = np.random.default_rng(5)
    sie = rng.random((12, 12, 9))
    sie[rng.random(sie.shape) < 0.2] = np.nan
    for scale, seed in ((0.12, 1), (0.5, 3), (1.0, 2)):
        got = north_star.subsample(sie, scale, seed)
        ref = sie.copy()
        if scale < 1.0:
            ref[np.random.default_rng(seed).random(sie.shape[:2]) > scale] = np.nan
        np.testing.assert_array_equal(got, ref)
        assert got is not sie
    np.testing.assert_array_equal(sie[np.isfinite(sie)], sie[np.isfinite(sie)])  # untouched


def test_north_star_score_is_bench_py_score():
    """``bench.py:446-452``: rmse over the finite cells of the field against
    the truth (the FYI file + 0.02 m at ``t_mid``)."""
    rng = np.random.default_rng(6)
    field = rng.normal(0.2, 0.05, (10, 10))
    field[rng.random((10, 10)) < 0.3] = np.nan
    fyi = rng.normal(0.2, 0.05, (10, 10, 9))
    cells, rmse = north_star.score(field, fyi, t_mid=4)
    scored = np.isfinite(field)
    truth = fyi[:, :, 4] + 0.02
    assert cells == int(scored.sum())
    assert rmse == float(np.sqrt(np.mean((field[scored] - truth[scored]) ** 2)))
