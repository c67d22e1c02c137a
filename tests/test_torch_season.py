"""The port's chained season (``pipeline.season.run_season`` in strided
waves) against the JAX package's, float64 on the CPU, and resumed from
pickles the JAX package wrote.

Setup and tolerances of ``test_torch_multiday.py``. Windows 0-3 in waves of
2: wave 0 is windows 0 and 2, cold; wave 1 is windows 1 and 3, each
started from its predecessor's fitted hypers. The JAX package's
``run_season`` on the same inputs is the reference, computed once for the
module. The chain-off and quicklook seasons are in
``test_torch_season_waves.py``, the ``season`` command in
``test_torch_season_cli.py``.
"""

import os
import shutil

import pytest

from optimalinterpolation_tpu.pipeline import season as JS
from optimalinterpolation_tpu_torch.io.pickles import load_pickle
from optimalinterpolation_tpu_torch.pipeline import season as TS

from .test_multiday import wave_season  # noqa: F401  (module-scoped fixture)
from .test_torch_multiday import assert_matches_jax, wave_cfg

DAYS = [0, 1, 2, 3]


def season_cfg(pkg: str, outdir, **kw):
    mod = JS if pkg == "jax" else TS
    return mod.SeasonConfig(daily=wave_cfg(pkg), outdir=str(outdir), write_quicklook=False,
                            day_parallel=2, **kw)


def pickles(outdir) -> list:
    return sorted(f for f in os.listdir(outdir) if f.endswith(".pkl"))


@pytest.fixture(scope="module")
def jax_season(wave_season, tmp_path_factory):  # noqa: F811
    """The JAX package's chained season over windows 0-3, and its outdir."""
    out = tmp_path_factory.mktemp("jax_season")
    res = JS.run_season(wave_season[0], season_cfg("jax", out), days=DAYS,
                        prior_fn=lambda d: 0.15, log=lambda s: None)
    return res, out


def test_run_season_waves_chain_and_resume(wave_season, jax_season, tmp_path):  # noqa: F811
    """Strided waves chain day p from day p - 1 across waves, as the JAX
    package does; a second run finds every pickle and runs nothing."""
    ds = wave_season[0]
    ref, jax_out = jax_season
    cfg = season_cfg("torch", tmp_path)
    lines = []
    first = TS.run_season(ds, cfg, days=DAYS, prior_fn=lambda d: 0.15, log=lines.append,
                          device="cpu")
    assert_matches_jax(first, ref)
    assert pickles(tmp_path) == pickles(jax_out) and len(pickles(tmp_path)) == 4
    assert_matches_jax([load_pickle(os.path.join(tmp_path, f)) for f in pickles(tmp_path)],
                       first)
    assert [line.split(":")[0] for line in lines] == ["[season] wave 1/2 (2 days)",
                                                      "[season] wave 2/2 (2 days)"]
    lines.clear()
    second = TS.run_season(ds, cfg, days=DAYS, prior_fn=lambda d: 0.15, log=lines.append,
                           device="cpu")
    assert second == [] and len(lines) == 4 and all("skipping (resume)" in s for s in lines)


def test_season_resumes_from_jax_pickles(wave_season, jax_season, tmp_path):  # noqa: F811
    """The JAX package's pickles of windows 0-2, then the port's run over
    windows 0-3: it skips those days, reads the chain from their pickles and
    gives window 3 of the JAX season, started from the JAX package's window
    2 fields. (With only windows 0-1 written, no day the port runs would
    chain from them: window 2 runs in wave 0, before window 1's chain is
    read.)"""
    ds = wave_season[0]
    ref, jax_out = jax_season
    for name in pickles(jax_out)[:3]:
        shutil.copy(os.path.join(jax_out, name), tmp_path)
    lines = []
    got = TS.run_season(ds, season_cfg("torch", tmp_path), days=DAYS,
                        prior_fn=lambda d: 0.15, log=lines.append, device="cpu")
    assert sum("skipping (resume)" in s for s in lines) == 3
    assert [r.date for r in got] == [ref[3].date]
    assert_matches_jax(got, ref[3:])
