"""The port's daily pipeline against the JAX package, float64 on the CPU.

``interpolate_daily`` of both packages runs on the same hand-sized dataset
(tests/reference_flow.make_tiny_dataset). The quicklook path takes the same
hyperparameter fields, some of them NaN; all 15 reference-dict fields agree
to 1e-9 with identical NaN masks. The two-pass day (fit, predict, smoothing,
second predict) runs with the same ``DailyConfig``, once without and once
with spatial seeding and the warm-start cascade, at buckets small enough
that the JAX package takes its plain objective: predictions agree to 1e-6 m,
hyper fields to 1e-5 relative (reached: ~1e-12 m and ~1e-10; both packages
run the same L-BFGS in the same order), and the stages, their cells and
their iteration sums are equal. Also: the port's CLI end to end, and that
the port never imports JAX.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from optimalinterpolation_tpu.models import optimizer as JO
from optimalinterpolation_tpu.pipeline import daily as JD
from optimalinterpolation_tpu_torch import cli
from optimalinterpolation_tpu_torch.models import optimizer as TO
from optimalinterpolation_tpu_torch.pipeline import daily as TD

from .reference_flow import make_tiny_dataset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hypers(ds):
    """Smoothly varying fields with two NaN cells inside the active disk."""
    g = ds.x.shape[0]
    wave = 1.0 + 0.2 * np.sin(np.arange(g)[:, None] / 3.0) * np.cos(np.arange(g)[None, :] / 4.0)
    res_m = ds.grid_res_km * 1e3
    h = {"ell_x": 2.5 * res_m * wave, "ell_y": 2.5 * res_m / wave, "ell_t": 2.0 * wave,
         "sf2": 0.004 * wave, "sn2": np.full((g, g), 4e-4)}
    c = g // 2
    h["sf2"][c, c] = np.nan
    h["ell_t"][c + 1, c - 2] = np.nan
    return h


def _prior_field(ds):
    """A (G, G) prior with NaN cells, which fall back to its finite mean."""
    field = 0.2 + 0.01 * np.cos(ds.x / 3e5) * np.sin(ds.y / 4e5)
    field[::5, ::3] = np.nan
    return field


@pytest.mark.parametrize("prior", ["scalar", "field"])
@pytest.mark.parametrize("buckets", [(512, 1024, 2048, 4096), (128, 256)])
def test_quicklook_day_matches_jax(buckets, prior):
    ds = make_tiny_dataset()
    hyp = _hypers(ds)
    mean = 0.2 if prior == "scalar" else _prior_field(ds)
    ref = JD.interpolate_daily(
        ds, 0, mean, JD.DailyConfig(dtype="float64", jitter=1e-6, buckets=buckets),
        precomputed_hypers=hyp,
    ).to_reference_dict()
    got = TD.interpolate_daily(
        ds, 0, mean, TD.DailyConfig(dtype="float64", jitter=1e-6, buckets=buckets),
        precomputed_hypers=hyp, device="cpu",
    ).to_reference_dict()
    assert list(got) == list(ref) and len(got) == 15
    active = np.isfinite(ds.sie[:, :, 4])
    for key, r in ref.items():
        g = got[key]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=key)
        if key.endswith("_lZ"):
            np.testing.assert_allclose(g, r, rtol=1e-9, atol=0, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, atol=1e-9, rtol=0, err_msg=key)
    interp = got[f"{ds.dates[4]}_interp_smth"]
    assert np.isfinite(interp[active]).sum() == active.sum() - 2  # the two NaN-hyper cells


def test_chunking_is_invisible(caplog):
    """Tiny chunks (many padded tiles) give the same fields as one chunk."""
    ds = make_tiny_dataset()
    hyp = _hypers(ds)
    one = TD.interpolate_daily(ds, 0, 0.2, TD.DailyConfig(dtype="float64", buckets=(256,)),
                               precomputed_hypers=hyp, device="cpu")
    with caplog.at_level("INFO", logger=TD.__name__):
        many = TD.interpolate_daily(
            ds, 0, 0.2, TD.DailyConfig(dtype="float64", buckets=(256,), max_chunk_bytes=4e6),
            precomputed_hypers=hyp, device="cpu",
        )
    (n, cells, tile, _), = [r.args for r in caplog.records if not isinstance(r.args, dict)]
    assert n == 256 and cells == np.isfinite(ds.sie[:, :, 4]).sum()
    assert tile < cells  # several chunks, the last one padded
    np.testing.assert_allclose(many.interp, one.interp, atol=1e-12, rtol=0)
    np.testing.assert_allclose(many.lZ, one.lZ, rtol=1e-12, atol=0)


def test_chunk_rows_tiles_evenly():
    cfg = TD.DailyConfig(max_chunk_bytes=16e9)
    # K2 scratch, (N^2 + 128 N) * 4 bytes a row: 3,384 rows fit at N = 1024,
    # so 8,000 rows go in 3 tiles of 2,672
    assert TD._chunk_rows(1024, 8000, cfg, 4) == 2672
    assert TD._chunk_rows(512, 56, cfg, 4) == 56
    # blocked, 2.5 (N, N) buffers a row: 88 rows fit at N = 4096
    assert TD._chunk_rows(4096, 1600, cfg, 4) == 88
    assert TD._chunk_rows(4096, 8, TD.DailyConfig(max_chunk_bytes=1.0), 4) == 8


def test_chunk_rows_optimize_model():
    cfg = TD.DailyConfig(max_chunk_bytes=16e9)
    # K3 with the gradient, (2 N^2 + 128 N) * 4 bytes a row: 1,797 rows fit at
    # N = 1024, so 8,936 rows go in 5 tiles of 1,792
    assert TD._chunk_rows(1024, 8936, cfg, 4, "fused") == 1792
    assert TD._chunk_rows(512, 1256, cfg, 4, "fused") == 1256
    # the plain autograd objective's buffers
    assert TD._chunk_rows(64, 56, cfg, 8, "xla") == 56
    # the blocked objective, _BLOCKED_OBJECTIVE_BUFFERS (N, N) a row
    rows = int(16e9 // (TD._BLOCKED_OBJECTIVE_BUFFERS * 2048 ** 2 * 4)) // 8 * 8
    assert TD._chunk_rows(2048, 4000, cfg, 4, "blocked") == -(-4000 // -(-4000 // rows) // 8) * 8
    assert TD._chunk_rows(2048, 8, cfg, 4, "blocked") == 8
    # the Nystrom objective: (N, M) and (M, M) buffers, no (N, N) one
    per_row = (TD._NYSTROEM_NM_BUFFERS * 4096 * 512 + TD._NYSTROEM_MM_BUFFERS * 512 ** 2) * 4
    assert TD._chunk_rows(4096, 100000, cfg, 4, "nystroem:512") <= 16e9 // per_row
    assert TD._chunk_rows(4096, 100000, cfg, 4, "nystroem:512") > 16e9 // per_row - 8


def test_requires_hypers_until_pass1_is_ported():
    """Pass 1 is ported, and so is every objective: ``backend="blocked"``
    runs the day through the blocked objective (K1's twin here), which the
    opt stage reports."""
    cfg = TD.DailyConfig(dtype="float64", buckets=(128,), spatial_seed_stride=0,
                         opt=TO.OptimizeConfig(backend="blocked", max_iters=3))
    stats = []
    res = TD.interpolate_daily(make_tiny_dataset(), 0, 0.2, cfg, stats=stats, device="cpu")
    opt = [e for e in stats if e["stage"] == "opt"]
    assert [e["backend"] for e in opt] == ["blocked"] and "m" not in opt[0]
    assert np.isfinite(res.interp_smth[np.isfinite(res.interp_smth)]).any()


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


def test_permute_valid_points_reproduces_the_jax_order():
    ds = make_tiny_dataset()
    from optimalinterpolation_tpu_torch.data.neighbors import gather_neighborhoods
    from optimalinterpolation_tpu_torch.data.window import flatten_window

    train = flatten_window(ds.obs[:, :, :, 0:9], ds.x, ds.y)
    ij = np.nonzero(np.isfinite(ds.sie[:, :, 4]))
    cells = np.stack([ds.x[ij], ds.y[ij]], axis=1)
    kw = dict(t_star=4.0, radius_m=300e3, buckets=(128, 256), dtype=np.float64)
    (a,), (b,) = gather_neighborhoods(train, cells, **kw), gather_neighborhoods(train, cells, **kw)
    np.testing.assert_array_equal(a.x, b.x)
    JD._permute_valid_points(a)
    TD._permute_valid_points(b)
    assert not np.array_equal(a.x, gather_neighborhoods(train, cells, **kw)[0].x)
    np.testing.assert_array_equal(b.x, a.x)
    np.testing.assert_array_equal(b.z, a.z)
    np.testing.assert_array_equal(b.mask, a.mask)


def test_load_hypers(tmp_path):
    ds = make_tiny_dataset()
    hyp = _hypers(ds)
    path = tmp_path / "h.npz"
    np.savez(path, **hyp)
    got = TD.load_hypers(str(path))
    for k in TD.HYPER_NAMES:
        np.testing.assert_array_equal(got[k], hyp[k])
        assert got[k].dtype == np.float64
    with pytest.raises(ValueError, match="missing"):
        TD.load_hypers({k: v for k, v in hyp.items() if k != "sn2"})


def _quicklook_daily(d: str, capsys) -> dict:
    """``daily --hypers H --quicklook`` on a synthetic 200 km season in
    ``d``: its JSON line."""
    cli.main(["synth", "--outdir", d, "--grid-res", "200", "--n-days", "9", "--seed", "3"])
    g = np.load(os.path.join(d, "x_200km.npy")).shape[0]
    np.savez(os.path.join(d, "h.npz"), **{k: np.full((g, g), v) for k, v in zip(
        TD.HYPER_NAMES, (2e5, 2e5, 2.0, 0.03, 0.005))})
    capsys.readouterr()
    cli.main(["daily", "--datapath", d, "--grid-res", "200", "--fyi",
              os.path.join(d, "CS2_FYI_synthetic_200km.npy"), "--fyi-offset", "0",
              "--hypers", os.path.join(d, "h.npz"), "--outdir", d, "--device", "cpu",
              "--quicklook"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_daily_writes_reference_pickle(tmp_path, capsys):
    d = str(tmp_path)
    line = _quicklook_daily(d, capsys)
    assert line["date"] == "20181205" and line["cells"] > 0
    with open(line["output"], "rb") as f:
        res = pickle.load(f)
    assert len(res) == 15 and f"{line['date']}_interp_error_smth" in res
    assert np.isfinite(res[f"{line['date']}_interp"]).sum() == line["cells"]
    from optimalinterpolation_tpu_torch.io.quicklook import read_quicklook

    q = read_quicklook(line["quicklook"])
    assert q.date == line["date"] and line["quicklook"].endswith("_200km_quicklook.nc")
    np.testing.assert_array_equal(q.radar_freeboard, res[f"{line['date']}_interp_smth"].T)


def test_cli_daily_quicklook_without_h5py(tmp_path, capsys, monkeypatch):
    """With h5py blocked ``daily --quicklook`` writes its NetCDF through
    ``io/hdf5.py`` and reads it back: the pickle's smoothed fields and the
    grid's lat / lon, transposed, bit for bit with NaNs in place."""
    from optimalinterpolation_tpu_torch.io.quicklook import grid_lonlat, read_quicklook

    monkeypatch.setitem(sys.modules, "h5py", None)  # ``import h5py`` raises ImportError
    d = str(tmp_path)
    line = _quicklook_daily(d, capsys)
    date = line["date"]
    with open(line["output"], "rb") as f:
        res = pickle.load(f)
    lon, lat = grid_lonlat(np.load(os.path.join(d, "x_200km.npy")),
                           np.load(os.path.join(d, "y_200km.npy")))
    q = read_quicklook(line["quicklook"])
    assert q.date == date and np.isnan(q.radar_freeboard).any()
    for got, ref in ((q.radar_freeboard, res[f"{date}_interp_smth"].T),
                     (q.uncertainty, res[f"{date}_interp_error_smth"].T),
                     (q.lat, lat.T), (q.lon, lon.T)):
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got.view(np.uint64),
                                      np.ascontiguousarray(ref, np.float64).view(np.uint64))


def test_cli_daily_without_hypers_runs_the_two_pass_day(tmp_path, capsys):
    d = str(tmp_path)
    cli.main(["synth", "--outdir", d, "--grid-res", "200", "--n-days", "9", "--seed", "3"])
    capsys.readouterr()
    cli.main(["daily", "--datapath", d, "--grid-res", "200", "--fyi",
              os.path.join(d, "CS2_FYI_synthetic_200km.npy"), "--fyi-offset", "0",
              "--outdir", d, "--device", "cpu", "--max-iters", "5",
              "--seed-stride", "3", "--opt-n-max", "128", "--warmstart-n", "64",
              "--restarts", "1", "--ftol", "1e-2", "--optimizer", "lbfgs"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["cells"] > 0
    with open(line["output"], "rb") as f:
        res = pickle.load(f)
    date = line["date"]
    assert len(res) == 15
    fitted = np.isfinite(res[f"{date}_interp"])
    assert fitted.sum() == line["cells"]
    for name in TD.HYPER_NAMES:  # fitted per cell, then smoothed: the fields differ
        raw, smth = res[f"{date}_{name}"], res[f"{date}_{name}_smth"]
        assert np.isfinite(raw[fitted]).all() and np.isfinite(smth[fitted]).all()
        assert not np.allclose(raw[fitted], smth[fitted])
    assert not np.allclose(res[f"{date}_interp"][fitted], res[f"{date}_interp_smth"][fitted])


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke.py, imports without JAX, the
    JAX package, h5py (which only the quicklook NetCDFs need) or matplotlib
    (which only ``cell --figure`` needs)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import optimalinterpolation_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):  # the CLI entry runs on import\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "need = [p.__name__ + '.' + m for m in ('pipeline.multiday', 'pipeline.season', "
        "'io.quicklook', 'data.projection', 'models.nystroem', 'models.svgp', 'models.bfgs', "
        "'viz', 'parallel.mesh')]\n"
        "assert all(m in sys.modules for m in need), need\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'optimalinterpolation_tpu', 'h5py', 'matplotlib'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
