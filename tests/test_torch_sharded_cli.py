"""The ``--devices`` CLI, float64 on the CPU: ``--devices 3`` with
``--device cpu`` writes the pickle that ``daily`` writes without it,
``--devices 2`` the pickles of a two-wave ``season``, and ``--devices`` of
cards that are not there raises.
"""

import os

import numpy as np
import pytest
import torch

from optimalinterpolation_tpu_torch import cli
from optimalinterpolation_tpu_torch.io.pickles import load_pickle


def _synth(tmp_path, capsys):
    d = str(tmp_path)
    cli.main(["synth", "--outdir", d, "--grid-res", "500", "--n-days", "11", "--seed", "3"])
    capsys.readouterr()
    return d, ["--datapath", d, "--grid-res", "500", "--fyi",
               os.path.join(d, "CS2_FYI_synthetic_500km.npy"), "--fyi-offset", "0",
               "--radius-km", "700", "--opt-n-max", "128", "--dtype", "float64",
               "--seed-stride", "0", "--warmstart-n", "0", "--max-iters", "10",
               "--device", "cpu"]


def _same_pickles(a: str, b: str, names):
    for name in names:
        ref, got = load_pickle(os.path.join(a, name)), load_pickle(os.path.join(b, name))
        assert list(got) == list(ref) and len(got) == 15
        for key, r in ref.items():
            np.testing.assert_array_equal(np.isnan(got[key]), np.isnan(r), err_msg=key)
            np.testing.assert_allclose(got[key], r, atol=1e-10, rtol=1e-10, err_msg=key)
        assert np.isfinite(next(v for k, v in got.items() if k.endswith("_interp_smth"))).any()


def test_cli_devices_gives_the_unsharded_pickles(tmp_path, capsys):
    d, common = _synth(tmp_path, capsys)
    for n in (None, 3):
        out = os.path.join(d, f"daily_{n}")
        cli.main(["daily", *common, "--outdir", out]
                 + ([] if n is None else ["--devices", str(n)]))
    names = [f for f in os.listdir(os.path.join(d, "daily_None")) if f.endswith(".pkl")]
    assert len(names) == 1
    _same_pickles(os.path.join(d, "daily_None"), os.path.join(d, "daily_3"), names)
    for n in (None, 2):
        cli.main(["season", *common, "--days", "0:3", "--day-parallel", "2", "--no-resume",
                  "--outdir", os.path.join(d, f"season_{n}")]
                 + ([] if n is None else ["--devices", str(n)]))
    names = sorted(f for f in os.listdir(os.path.join(d, "season_None")) if f.endswith(".pkl"))
    assert len(names) == 3
    _same_pickles(os.path.join(d, "season_None"), os.path.join(d, "season_2"), names)
    if not torch.cuda.is_available():  # --devices of cards that are not there
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["daily", *common[:-2], "--outdir", d, "--devices", "2"])
