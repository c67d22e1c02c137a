"""The port's day with every bucket's cells sharded over several devices
(``cell_sharding``, ``parallel/mesh.py``), float64 on the CPU.

Setup of ``tests/test_pipeline.py::test_pipeline_sharded_matches_unsharded``:
its ``small_season`` (125 km, active set thinned to every 3rd cell) and its
configuration (``window_days=9``, ``radius_km=450``, ``max_iters=8``,
buckets (128, 512), ``batch_multiple=8``, float64), in four cases: that
configuration as it is (``flat``, here); with the spatial seeding and the
warm-start cascade on (``seeded``: ``_permute_valid_points`` shuffles a
bucket before its rows are split); chained from the seeded day's hypers
(``chained``: ``init_hypers``, where the bucket's ``chained`` is decided);
and the Adam fit (``adam``). The seeded and chained cases are in
``test_torch_sharded_paths.py``, the Adam case in
``test_torch_sharded_adam.py``, the comparisons with the JAX package in
``test_torch_sharded_jax.py``; they take their helpers from here. The CLI
is in ``test_torch_sharded_cli.py``. CPU shards run the kernels' plain
twins, as every CPU test does.

A sharded day, on 3 shards and on 16 (which leaves shards empty), gives the
unsharded day's 15 fields within 1e-10 m (1e-10 relative for lZ and the
hyper fields) with the same NaN cells, and stage entries equal in names, N,
cells, iteration sums and converged cells. Against the JAX package's day
sharded over the 8 virtual CPU devices of ``tests/conftest.py``: the
cross-package tolerances of ``tests/test_torch_multiday.py`` (1e-6 m, 1e-5
relative) and the same stage entries.
"""
import numpy as np
import pytest

from optimalinterpolation_tpu.models import optimizer as JO
from optimalinterpolation_tpu.parallel import mesh as JMESH
from optimalinterpolation_tpu.pipeline import daily as JD
from optimalinterpolation_tpu_torch.models import optimizer as TO
from optimalinterpolation_tpu_torch.parallel.mesh import cell_sharding, make_mesh
from optimalinterpolation_tpu_torch.pipeline import daily as TD

from .test_pipeline import small_season  # noqa: F401  (module-scoped fixture)
from .test_torch_multiday import assert_matches_jax

PACKAGES = {"jax": (JD, JO), "torch": (TD, TO)}
# the cases, as DailyConfig and OptimizeConfig fields beside the JAX test's
CASES = {
    "flat": ({}, {}),
    "seeded": (dict(spatial_seed_stride=2, seed_opt_n=32, warmstart_n_seeded=32,
                    warmstart_n=64, opt_n_max=64), {}),
    "chained": (dict(opt_n_max=64), {}),
    "adam": ({}, {"method": "adam"}),
}
STAGE_FIELDS = ("stage", "n", "cells", "iters_sum", "converged")


def sharded_cfg(pkg: str, case: str):
    """``test_pipeline_sharded_matches_unsharded``'s configuration in either
    package, with ``case``'s fields."""
    mod, opt_mod = PACKAGES[pkg]
    daily_kw, opt_kw = CASES[case]
    return mod.DailyConfig(window_days=9, radius_km=450.0, buckets=(128, 512),
                           batch_multiple=8, dtype="float64",
                           opt=opt_mod.OptimizeConfig(max_iters=8, **opt_kw), **daily_kw)


def _entries(stats, fields=STAGE_FIELDS):
    return [tuple(e.get(f) for f in fields) for e in stats]


@pytest.fixture(scope="module")
def runs(small_season):  # noqa: F811
    """The port's day of each case, unsharded or on ``n`` CPU shards,
    computed once: ``runs(case, n)`` -> (reference dict, stage entries)."""
    ds = small_season[0]
    cache = {}

    def run(case, n_shards=None):
        if (case, n_shards) not in cache:
            init = None
            if case == "chained":  # the seeded day's hypers, a few cells newly active
                init = {k: v.copy() for k, v in run("seeded")[0]["hypers"].items()}
                ii, jj = np.nonzero(np.isfinite(init["sf2"]))
                for v in init.values():
                    v[ii[:3], jj[:3]] = np.nan
            sharding = (None if n_shards is None
                        else cell_sharding(make_mesh(devices=["cpu"] * n_shards)))
            stats = []
            res = TD.interpolate_daily(ds, 0, 0.15, sharded_cfg("torch", case), stats=stats,
                                       init_hypers=init, device="cpu", cell_sharding=sharding)
            cache[case, n_shards] = ({**res.to_reference_dict(), "hypers": res.hypers}, stats)
        return cache[case, n_shards]

    return run


def _fields(d):
    return {k: v for k, v in d.items() if k != "hypers"}


def check_sharded_day(runs, case, n_shards):
    """``runs(case, n_shards)`` against ``runs(case)`` (see the module
    docstring)."""
    base, base_stats = runs(case)
    got, stats = runs(case, n_shards)
    base, got = _fields(base), _fields(got)
    assert list(got) == list(base) and len(got) == 15
    for key, b in base.items():
        np.testing.assert_array_equal(np.isnan(got[key]), np.isnan(b), err_msg=key)
        if key.endswith(("_interp", "_interp_error", "_interp_smth", "_interp_error_smth")):
            np.testing.assert_allclose(got[key], b, atol=1e-10, rtol=0, err_msg=key)
        else:  # lZ and the ten hyper fields
            np.testing.assert_allclose(got[key], b, rtol=1e-10, atol=0, err_msg=key)
    assert _entries(stats) == _entries(base_stats)
    stages = [e["stage"] for e in stats]
    assert stages.count("smooth") == 1 and "shards" not in stats[stages.index("smooth")]
    sharded = [e for e in stats if e["stage"] != "smooth"]
    # 16 shards of the 32-row 128 bucket: 4 ran, 12 were empty
    assert all(1 <= e["shards"] <= min(n_shards, e["cells"] // 8) for e in sharded)
    if case == "seeded":
        assert stages.index("seed:opt") < stages.index("cascade") < stages.index("opt")
    if case == "chained":
        assert not any(s.startswith("seed:") or s == "cascade" for s in stages)


def check_against_jax_sharded(small_season, runs, case):  # noqa: F811
    """The JAX package's day over ``make_mesh()``'s 8 virtual devices, as
    its own sharded test runs it, against the port's on 3 CPU shards."""
    mesh = JMESH.make_mesh()
    assert mesh.size == 8
    jstats = []
    ref = JD.interpolate_daily(small_season[0], 0, 0.15, sharded_cfg("jax", case),
                               cell_sharding=JMESH.cell_sharding(mesh), stats=jstats)
    got, stats = runs(case, 3)
    assert_matches_jax([_fields(got)], [ref.to_reference_dict()])
    fields = ("stage", "n", "cells", "iters_sum")
    assert _entries(stats, fields) == _entries(jstats, fields)


@pytest.mark.parametrize("n_shards", [3, 16])
def test_sharded_day_matches_unsharded(runs, n_shards):
    check_sharded_day(runs, "flat", n_shards)
