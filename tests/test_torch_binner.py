"""The port's along-track binner (``data/binner.py``) against the JAX
package's, on seeded ``.proc`` files written as ``tests/test_data_plane.py``
writes them (8 columns, freeboard in column 4, the flag in column 7; some
invalid flags, out-of-range freeboards and ``nan`` tokens): the fields, the
season pickle and the ``x_``/``y_`` grids are equal, and the parse equals
the plain ``np.genfromtxt`` path at rtol 1e-9.
"""

import numpy as np
import pytest

from optimalinterpolation_tpu.data import binner as JB
from optimalinterpolation_tpu.io.pickles import load_pickle as jload
from optimalinterpolation_tpu_torch.data import binner as TB
from optimalinterpolation_tpu_torch.data.projection import PolarStereo
from optimalinterpolation_tpu_torch.io.pickles import load_pickle


def _write_proc(path, rng, n, nan_rows=3):
    cols = np.zeros((n, 8))
    cols[:, 0] = rng.uniform(-180, 180, n)
    cols[:, 1] = rng.uniform(62, 89, n)
    cols[:, 2:4] = rng.normal(size=(n, 2))
    cols[:, 4] = rng.uniform(-0.5, 0.8, n)  # some outside [-0.37, 0.63]
    cols[:, 5:7] = rng.normal(size=(n, 2))
    cols[:, 7] = rng.choice([1, 2, 3], n, p=[0.2, 0.7, 0.1])
    lines = [" ".join(f"{v:.9g}" for v in row) for row in cols]
    for i in rng.choice(n, nan_rows, replace=False):
        tok = lines[i].split()
        tok[4] = "nan"
        lines[i] = " ".join(tok)
    path.write_text("\n".join(lines) + "\n")


def test_bin_points_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1e5, 8.1e6, 20000)  # some outside the domain
    y = rng.uniform(-1e5, 8.1e6, 20000)
    v = rng.normal(0.1, 0.05, 20000)
    v[::97] = np.nan
    for res in (25, 200, 500):
        got, ref = TB.bin_points(x, y, v, res), JB.bin_points(x, y, v, res)
        assert got.shape == ref.shape == (int(8e6 / (res * 1e3)),) * 2
        np.testing.assert_array_equal(got, ref)


def test_read_proc_file_matches_jax_and_genfromtxt(tmp_path):
    rng = np.random.default_rng(2)
    path = tmp_path / "CS2_20190101_v1.proc"
    _write_proc(path, rng, 2000)
    got = TB.read_proc_file(str(path))
    ref = JB.read_proc_file(str(path))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    data = np.genfromtxt(path)  # the plain path
    fb = data[:, 4]
    keep = (data[:, 7] == 2) & (fb >= -0.37) & (fb <= 0.63) & np.isfinite(fb)
    for a, b in zip(got, (data[keep, 0], data[keep, 1], fb[keep])):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)
    assert 0 < len(got[2]) < 2000


def test_read_proc_file_raises_on_a_ragged_file(tmp_path):
    path = tmp_path / "bad.proc"
    path.write_text("1 2 3 4 5 6 7 2\n1 2 3\n")
    with pytest.raises(RuntimeError, match="native parse failed"):
        TB.read_proc_file(str(path))


def test_read_and_bin_day_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    files = []
    for k in range(3):
        files.append(tmp_path / f"t{k}_20181203_v1.proc")
        _write_proc(files[-1], rng, 1500)
    files = [str(f) for f in files]
    proj = PolarStereo.from_boundinglat(60.0, 0.0)
    got = TB.read_and_bin_day(files, 50, proj=proj)
    ref = JB.read_and_bin_day(files, 50)
    assert got.shape == (160, 160) and np.isfinite(got).sum() > 100
    np.testing.assert_array_equal(got, ref)
    assert TB.read_and_bin_day([], 50) is None


def test_run_season_binning_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    raw = tmp_path / "raw"
    for month, days in (("201811", (1, 30)), ("201901", (2,))):
        (raw / month).mkdir(parents=True)
        for day in days:
            for track in range(2):
                _write_proc(raw / month / f"CS2_{track}_{month}{day:02d}_v1.proc", rng, 800)
    # a file of another product version is not read
    _write_proc(raw / "201811" / "CS2_0_20181105_v3.proc", rng, 50)
    got = TB.run_season_binning(str(raw), str(tmp_path / "torch"), "CS2_SAR", "2018-2019", 100)
    ref = JB.run_season_binning(str(raw), str(tmp_path / "jax"), "CS2_SAR", "2018-2019", 100)
    assert sorted(got) == sorted(ref) == ["20181101", "20181130", "20190102"]
    name = "CS2_SAR_dailyFB_100km_2018-2019_season.pkl"
    pk_t, pk_j = load_pickle(str(tmp_path / "torch" / name)), jload(str(tmp_path / "jax" / name))
    assert sorted(pk_t) == sorted(pk_j) == sorted(got)
    for date in pk_j:
        np.testing.assert_array_equal(pk_t[date], pk_j[date])
        np.testing.assert_array_equal(got[date], ref[date])
    for f in ("x_100km.npy", "y_100km.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "torch" / f), np.load(tmp_path / "jax" / f))
    assert TB.SEASONS == JB.SEASONS
