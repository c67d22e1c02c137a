"""The port's ``daily`` command end to end on a synthetic 200 km season,
float64 on the CPU: the quicklook day (``--hypers``, ``--quicklook``) writes
the reference pickle and the quicklook NetCDF, also with h5py blocked, and
the two-pass day without ``--hypers`` fits every cell.
"""

import json
import os
import pickle
import sys

import numpy as np

from optimalinterpolation_tpu_torch import cli
from optimalinterpolation_tpu_torch.pipeline import daily as TD


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
