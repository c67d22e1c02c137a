"""The production chain around the day through the port's CLI, on the CPU:
``tests/test_cli.py``'s cases (the hypers workflow with its regrid branch,
``--prior-background``, ``validate`` on perfect points) on the same tiny
250 km season, ``bin`` and ``hypers`` / ``validate`` against the JAX CLI on
the same inputs, and ``--profile`` writing a trace.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from optimalinterpolation_tpu import cli as jcli
from optimalinterpolation_tpu_torch.cli import main
from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season
from optimalinterpolation_tpu_torch.io.pickles import load_pickle

HYPERS = ("ell_x", "ell_y", "ell_t", "sf2", "sn2")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tiny_season(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("cli_season"))
    make_synthetic_season(outdir, grid_res_km=250, n_days=9, seed=7, noise_std=0.03,
                          tracks_per_day=(3, 1, 2, 2))
    return outdir


def _daily_args(tiny_season, out):
    """``tests/test_cli.py``'s day, its fit on 128-point subsamples (the
    float64 plain objective at N = 512 takes ~50 s on the CPU)."""
    return ["daily", "--datapath", tiny_season, "--grid-res", "250", "--prior-mean", "0.15",
            "--max-iters", "5", "--seed-stride", "0", "--dtype", "float64", "--device", "cpu",
            "--opt-n-max", "128", "--outdir", out]


@pytest.fixture(scope="module")
def day_run(tiny_season, tmp_path_factory):
    """One float64 two-pass day through the port's ``daily``: (outdir, its
    JSON line)."""
    out = str(tmp_path_factory.mktemp("day"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(_daily_args(tiny_season, out))
    return out, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_hypers_cli_quicklook_workflow(tiny_season, day_run, tmp_path, capsys):
    """Fitted day -> seasonal-average hyper .npz (and regridded) -> the
    quicklook re-predict with ``--hypers``."""
    out, _ = day_run
    npz = str(tmp_path / "hypers.npz")
    main(["hypers", "--indir", out, "--grid-res", "250", "--out", npz])
    info = _last_json(capsys)
    assert info["days"] == 1 and info["finite_cells"] > 0 and info["shape"] == [32, 32]
    assert set(np.load(npz).files) == set(HYPERS)

    out2 = str(tmp_path / "pass2")
    os.makedirs(out2)
    main(_daily_args(tiny_season, out2) + ["--hypers", npz])
    assert _last_json(capsys)["cells"] > 0

    coarse = str(tmp_path / "coarse")
    make_synthetic_season(coarse, grid_res_km=500, n_days=9, seed=7, tracks_per_day=(3, 1, 2, 2))
    npz2 = str(tmp_path / "hypers_500.npz")
    main(["hypers", "--indir", out, "--grid-res", "250", "--out", npz2, "--datapath",
          tiny_season, "--target-grid-res", "500", "--target-datapath", coarse])
    info3 = _last_json(capsys)
    assert info3["shape"] == [16, 16] and info3["finite_cells"] > 0


HYPERS_CASES = {
    "smoothed": [],
    "raw": ["--raw"],
    "regrid 500 km, footprint": ["--target-grid-res", "500"],
    "regrid 500 km, no fill": ["--target-grid-res", "500", "--no-fill"],
    "regrid 500 km, builtin mask": ["--target-grid-res", "500", "--ocean-mask", "builtin"],
}


@pytest.mark.parametrize("case", list(HYPERS_CASES))
def test_hypers_npz_matches_jax(tiny_season, day_run, tmp_path, capsys, case):
    """The port's ``hypers`` and the JAX package's, on the same pickles,
    write the same ``.npz`` and the same JSON line."""
    out, _ = day_run
    extra = HYPERS_CASES[case]
    if "--target-grid-res" in extra:
        coarse = str(tmp_path / "coarse")
        make_synthetic_season(coarse, grid_res_km=500, n_days=9, seed=7,
                              tracks_per_day=(3, 1, 2, 2))
        extra = extra + ["--datapath", tiny_season, "--target-datapath", coarse]
    lines, files = [], []
    for tag, run in (("torch", main), ("jax", jcli.main)):
        npz = str(tmp_path / f"{tag}.npz")
        run(["hypers", "--indir", out, "--grid-res", "250", "--out", npz] + extra)
        line = _last_json(capsys)
        line.pop("out")
        lines.append(line)
        files.append(np.load(npz))
    assert lines[0] == lines[1] and lines[0]["finite_cells"] > 0
    assert sorted(files[0].files) == sorted(files[1].files) == sorted(HYPERS)
    for name in HYPERS:
        np.testing.assert_array_equal(files[0][name], files[1][name], err_msg=name)


def test_daily_cli_prior_background(tiny_season, day_run, tmp_path, capsys):
    """``--prior-background N``: the first-N-days mean field with pole-hole
    fill is each cell's prior mean, and it moves the product off the
    constant prior's."""
    args = _daily_args(tiny_season, str(tmp_path))
    i = args.index("--prior-mean")
    main(args[:i] + args[i + 2:] + ["--prior-background", "9"])
    info = _last_json(capsys)
    assert info["cells"] == day_run[1]["cells"] > 0
    key = f"{info['date']}_interp"
    field, constant = load_pickle(info["output"])[key], load_pickle(day_run[1]["output"])[key]
    assert np.isfinite(field).sum() == info["cells"]
    assert not np.allclose(field[np.isfinite(field)], constant[np.isfinite(constant)])


def test_validate_cli_skill_metrics(tiny_season, day_run, tmp_path, capsys):
    """Perfect point observations sampled from the field itself score bias
    0, rmse 0, corr 1 and coverage 1; the JAX CLI reads the same."""
    out, info = day_run
    date = info["date"]
    field = load_pickle(info["output"])[f"{date}_interp"]
    gx = np.load(f"{tiny_season}/x_250km.npy")[:, 0]
    gy = np.load(f"{tiny_season}/y_250km.npy")[0, :]
    ix, iy = np.nonzero(np.isfinite(field))
    pts = str(tmp_path / "points.npz")
    np.savez(pts, x=gx[ix], y=gy[iy], value=field[ix, iy],
             date=np.full(ix.shape, date, dtype="U8"))
    args = ["validate", "--indir", out, "--datapath", tiny_season, "--grid-res", "250",
            "--points", pts]
    main(args)
    stats = _last_json(capsys)
    assert stats["days"] == 1 and stats["n"] == ix.size and stats["coverage"] == 1.0
    assert abs(stats["bias"]) < 1e-12 and stats["rmse"] < 1e-12
    assert stats["corr"] > 0.999999
    assert stats["mean_z"] < 1e-9
    jcli.main(args)
    assert _last_json(capsys) == stats


def test_bin_cli_matches_jax(tmp_path, capsys):
    """``bin`` over a month directory of seeded ``.proc`` files, through
    both CLIs: the same JSON line, season pickle and grid files."""
    rng = np.random.default_rng(12)
    month = "201812"
    raw = tmp_path / "raw" / month
    raw.mkdir(parents=True)
    for day in (1, 2, 5):
        for track in range(2):
            n = 300
            cols = np.zeros((n, 8))
            cols[:, 0] = rng.uniform(-180, 180, n)
            cols[:, 1] = rng.uniform(66, 88, n)
            cols[:, 4] = rng.uniform(-0.5, 0.8, n)
            cols[:, 7] = rng.choice([1, 2], n)
            np.savetxt(raw / f"CS2_{track}_{month}{day:02d}_v1.proc", cols, fmt="%.9g")
    lines = []
    for tag, run in (("torch", main), ("jax", jcli.main)):
        run(["bin", "--datapath", str(tmp_path / "raw"), "--outdir", str(tmp_path / tag),
             "--sat", "CS2_SAR", "--grid-res", "200"])
        lines.append(_last_json(capsys))
    assert lines[0] == lines[1] == {"days_binned": 3}
    name = "CS2_SAR_dailyFB_200km_2018-2019_season.pkl"
    got, ref = load_pickle(str(tmp_path / "torch" / name)), load_pickle(str(tmp_path / "jax" / name))
    assert sorted(got) == sorted(ref) == ["20181201", "20181202", "20181205"]
    for date in ref:
        np.testing.assert_array_equal(got[date], ref[date], err_msg=date)
        assert np.isfinite(got[date]).sum() > 0
    for f in ("x_200km.npy", "y_200km.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "torch" / f), np.load(tmp_path / "jax" / f))


def test_profile_writes_a_trace_on_cpu(tiny_season, tmp_path, capsys):
    """``--profile LOGDIR`` on the quicklook day: one Chrome trace under
    LOGDIR with the run's host operations (no device events on the CPU)."""
    g = 32
    npz = str(tmp_path / "const.npz")
    np.savez(npz, **{k: np.full((g, g), v) for k, v in
                     dict(ell_x=6e5, ell_y=6e5, ell_t=2.0, sf2=0.03, sn2=0.005).items()})
    logdir = str(tmp_path / "prof")
    main(_daily_args(tiny_season, str(tmp_path)) + ["--hypers", npz, "--profile", logdir])
    assert _last_json(capsys)["cells"] > 0
    (name,) = os.listdir(logdir)
    assert name.endswith(".pt.trace.json")
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert not any(e.get("cat") == "kernel" for e in events)
