"""The port's two-pass day with the Nystrom objective routed, against the
JAX package, float64 on the CPU.

Both packages run ``interpolate_daily`` on the same hand-sized dataset
(tests/reference_flow.make_tiny_dataset) with ``nystroem_min_n = 256`` and
``nystroem_m = 128``, so that the 256 bucket is fitted on the rank-128
Nystrom objective (``ops.nystroem_gp``; K1's plain twin under its
factorizations here) while the predicts stay exact. A file of its own: the
JAX package compiles its Nystrom sweep once for it (~10 s).
"""

import numpy as np

from optimalinterpolation_tpu.models import optimizer as JO
from optimalinterpolation_tpu.pipeline import daily as JD
from optimalinterpolation_tpu_torch.models import optimizer as TO
from optimalinterpolation_tpu_torch.pipeline import daily as TD

from .reference_flow import make_tiny_dataset


def test_nystroem_routed_day_matches_jax():
    """The two-pass day with the Nystrom objective routed in both packages
    (nystroem_min_n = 256, M = 128: the 256 bucket's fit; the tiny dataset
    at coverage 0.15 instead of 0.08, so that its cells fill the 256
    bucket): stage
    names, N, m, cells and iteration sums equal; fields within 1e-6 m,
    hypers and lZ within 1e-5 relative."""
    ds = make_tiny_dataset(coverage=0.15)
    stats = {}
    out = {}
    for name, mod, opt_mod in (("jax", JD, JO), ("torch", TD, TO)):
        cfg = mod.DailyConfig(
            dtype="float64", jitter=1e-6, buckets=(64, 128, 256), spatial_seed_stride=0,
            opt=opt_mod.OptimizeConfig(max_iters=15, ftol_abs=1e-3, nystroem_min_n=256,
                                       nystroem_m=128))
        extra = {"device": "cpu"} if mod is TD else {}
        stats[name] = []
        out[name] = mod.interpolate_daily(ds, 0, 0.2, cfg, stats=stats[name],
                                          **extra).to_reference_dict()
    fields = ("stage", "n", "cells", "iters_sum", "m")
    assert [[e.get(f) for f in fields] for e in stats["torch"]] == [
        [e.get(f) for f in fields] for e in stats["jax"]]
    opt = [e for e in stats["torch"] if e["stage"] == "opt"]
    assert [(e["n"], e["backend"], e.get("m")) for e in opt] == [(256, "nystroem", 128)]
    for key, r in out["jax"].items():
        g = out["torch"][key]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=key)
        if "interp" in key:
            np.testing.assert_allclose(g, r, atol=1e-6, rtol=0, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=0, err_msg=key)
