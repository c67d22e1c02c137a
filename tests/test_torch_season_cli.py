"""The port's ``season`` command against the JAX package's, float64 on the
CPU, on one small synthetic season written by ``synth``.

Both commands run windows 0-3 in two strided waves, chained, and write a
pickle and a quicklook NetCDF per day under the same names. Pickles agree
within the cross-package tolerances of ``test_torch_multiday.py``; each
NetCDF, read back through either package's ``read_quicklook``, agrees with
the other package's within the same tolerances. The grid (500 km), radius
(700 km) and the 128-point cap on the fit keep the run small; every fit is
below both packages' Nystrom threshold, so both take the exact objective.
"""

import os

import numpy as np
import pytest

from optimalinterpolation_tpu import cli as jcli
from optimalinterpolation_tpu.io import quicklook as JQ
from optimalinterpolation_tpu_torch import cli as tcli
from optimalinterpolation_tpu_torch.io import quicklook as TQ
from optimalinterpolation_tpu_torch.io.pickles import load_pickle

from .test_torch_multiday import assert_matches_jax

RES = "500"


@pytest.fixture(scope="module")
def season_runs(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("data"))
    tcli.main(["synth", "--outdir", data, "--grid-res", RES, "--n-days", "12", "--seed", "3"])
    args = ["season", "--datapath", data, "--grid-res", RES, "--fyi",
            os.path.join(data, f"CS2_FYI_synthetic_{RES}km.npy"), "--fyi-offset", "0",
            "--radius-km", "700", "--opt-n-max", "128", "--dtype", "float64",
            "--seed-stride", "0", "--warmstart-n", "0", "--max-iters", "10", "--days", "0:4",
            "--day-parallel", "2", "--no-resume"]
    out = {}
    for name, main, extra in (("jax", jcli.main, []), ("torch", tcli.main, ["--device", "cpu"])):
        out[name] = str(tmp_path_factory.mktemp(name))
        main(args + ["--outdir", out[name]] + extra)
    return out


def _files(d, suffix):
    return sorted(f for f in os.listdir(d) if f.endswith(suffix))


def test_season_command_matches_jax(season_runs):
    jax_dir, torch_dir = season_runs["jax"], season_runs["torch"]
    names = _files(jax_dir, ".pkl")
    assert _files(torch_dir, ".pkl") == names and len(names) == 4
    got = [load_pickle(os.path.join(torch_dir, f)) for f in names]
    ref = [load_pickle(os.path.join(jax_dir, f)) for f in names]
    assert_matches_jax(got, ref)
    for g in got:  # every day fitted somewhere
        assert np.isfinite(next(v for k, v in g.items() if k.endswith("_interp_smth"))).any()


def test_season_command_quicklook_netcdfs_match_jax(season_runs):
    jax_dir, torch_dir = season_runs["jax"], season_runs["torch"]
    names = _files(jax_dir, "_quicklook.nc")
    assert _files(torch_dir, "_quicklook.nc") == names and len(names) == 4
    for name in names:
        for read in (JQ.read_quicklook, TQ.read_quicklook):
            g = read(os.path.join(torch_dir, name))
            r = read(os.path.join(jax_dir, name))
            assert g.date == r.date and name.startswith(f"CS2S3_{g.date}_")
            np.testing.assert_array_equal(g.lat, r.lat)
            np.testing.assert_array_equal(g.lon, r.lon)
            for field in ("radar_freeboard", "uncertainty"):
                a, b = getattr(g, field), getattr(r, field)
                np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=field)
