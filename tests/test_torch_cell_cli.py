"""The port's ``cell`` command against the JAX package's, float64 on the CPU.

Both CLIs run on the same tiny season with ``tests/test_cli.py::_run_cell``'s
arguments (the port with ``--device cpu``). Exact (L-BFGS and Adam) and
Nystrom (BFGS, 64 landmarks drawn by the same seeded numpy generator): the
mean, std, lZ / NLL and hyperparameters agree to 1e-6 relative, with equal
iterations (reached: ~1e-12). SVGP draws its minibatches from a torch
generator, which JAX's stream cannot match: the JAX test's checks. Also the
empty neighbourhood, ``--figure`` (and without matplotlib) and ``daily
--optimizer adam``.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

from optimalinterpolation_tpu.cli import main as jax_main
from optimalinterpolation_tpu_torch.cli import main
from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season


@pytest.fixture(scope="module")
def tiny_season(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("cell_season"))
    make_synthetic_season(outdir, grid_res_km=250, n_days=9, seed=7, noise_std=0.03,
                          tracks_per_day=(3, 1, 2, 2))
    return outdir


def _cell_argv(tiny_season, *extra):
    return ["cell", "--datapath", tiny_season, "--grid-res", "250", "--prior-mean", "0.15",
            "--x", "4e6", "--y", "4e6", "--radius-km", "700", "--max-iters", "8",
            "--dtype", "float64", *extra]


def _json(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _run(tiny_season, *extra):
    """(JAX line, port line) of one ``cell`` call."""
    argv = _cell_argv(tiny_season, *extra)
    return _json(jax_main, argv), _json(main, argv + ["--device", "cpu"])


@pytest.mark.parametrize("extra", [(), ("--optimizer", "adam"),
                                   ("--method", "nystroem", "--landmarks", "64")],
                         ids=["exact", "exact-adam", "nystroem"])
def test_cell_matches_jax(tiny_season, extra):
    ref, got = _run(tiny_season, *extra)
    assert set(got) == set(ref)
    for key in ("date", "method", "n_points", "prior_mean", "iters", "landmarks"):
        assert got.get(key) == ref.get(key), key
    for key in ("mean", "std", "lZ", "prior_std", "nll"):
        if key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, err_msg=key)
    for name, v in ref["hypers"].items():
        np.testing.assert_allclose(got["hypers"][name], v, rtol=1e-6, err_msg=name)
    assert ref["n_points"] > 10 and np.isfinite(got["mean"]) and got["std"] > 0


def test_cell_methods_agree_and_svgp(tiny_season):
    """tests/test_cli.py's cross-method checks through the port."""
    argv = _cell_argv(tiny_season, "--device", "cpu")
    exact = _json(main, argv)
    nyst = _json(main, argv + ["--method", "nystroem", "--landmarks", "64"])
    assert abs(nyst["mean"] - exact["mean"]) < 0.05 and nyst["std"] > 0
    svgp = _json(main, argv + ["--method", "svgp", "--svgp-iters", "100",
                               "--num-inducing", "16"])
    assert np.isfinite(svgp["elbo"]) and np.isfinite(svgp["mean"]) and svgp["std"] > 0
    assert set(svgp["hypers"]) == {"ell_x", "ell_y", "ell_t", "sf2", "sn2"}
    assert np.isfinite(svgp["learned_mean"])


def test_cell_figure_writes_both_pngs(tiny_season, tmp_path):
    fig = str(tmp_path / "cell")
    line = _json(main, _cell_argv(tiny_season, "--device", "cpu", "--method", "svgp",
                                  "--svgp-iters", "20", "--num-inducing", "8",
                                  "--figure", fig))
    assert line["figures"] == [f"{fig}_pdf.png", f"{fig}_footprint.png"]
    for f in line["figures"]:
        with open(f, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_cell_figure_without_matplotlib_fails_before_the_fit(tiny_season, tmp_path,
                                                             monkeypatch):
    """Without matplotlib ``cell --figure`` raises the RuntimeError naming it
    before any fit, and writes nothing."""
    from optimalinterpolation_tpu_torch.models import optimizer

    def never(*args, **kwargs):
        raise AssertionError("the cell was fitted")

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # ``import matplotlib`` raises
    monkeypatch.setattr(optimizer, "optimize_mll", never)
    with pytest.raises(RuntimeError, match="matplotlib"):
        main(_cell_argv(tiny_season, "--device", "cpu", "--figure", str(tmp_path / "cell")))
    assert os.listdir(tmp_path) == []


def test_cell_rejects_empty_neighborhood(tiny_season):
    with pytest.raises(SystemExit, match="no observations"):
        main(["cell", "--datapath", tiny_season, "--grid-res", "250", "--prior-mean", "0.15",
              "--x", "9e9", "--y", "9e9", "--radius-km", "100", "--dtype", "float64",
              "--device", "cpu"])


def test_daily_cli_with_adam(tiny_season, tmp_path):
    out = str(tmp_path)
    line = _json(main, ["daily", "--datapath", tiny_season, "--grid-res", "250",
                        "--prior-mean", "0.15", "--optimizer", "adam", "--max-iters", "2",
                        "--dtype", "float64", "--outdir", out, "--device", "cpu"])
    assert line["cells"] > 0 and os.path.exists(line["output"])
