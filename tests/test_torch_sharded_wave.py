"""A sharded wave of days (``interpolate_days(cell_sharding=...)``) against
the port's unsharded wave and the JAX package's sharded wave, float64 on
the CPU.

Setup of ``tests/test_multiday.py::test_wave_day_cell_mesh_sharding_matches_unsharded``:
its ``wave_season`` and its ``_CFG`` (through
``test_torch_multiday.wave_cfg``), the wave of windows 0 and 2. The JAX
package shards each combined bucket over both axes of a (2, 4) (days,
cells) mesh of ``tests/conftest.py``'s 8 virtual CPU devices; the port over
``day_cell_mesh((2, 4))`` of CPU shards, the same 8-way split flattened.
Against the port's unsharded wave: every field of both days within 1e-10 m
(1e-10 relative for lZ and the hypers) and the same stage entries (names,
N, cells, iteration sums, converged cells). Against the JAX wave: the
cross-package tolerances of ``test_torch_multiday.assert_matches_jax`` and
the same stage entries (names, N, cells, iteration sums).
"""

import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from optimalinterpolation_tpu.parallel.mesh import day_cell_mesh as jax_day_cell_mesh
from optimalinterpolation_tpu.pipeline import multiday as JM
from optimalinterpolation_tpu_torch.parallel.mesh import cell_sharding, day_cell_mesh
from optimalinterpolation_tpu_torch.pipeline import multiday as TM

from .test_multiday import wave_season  # noqa: F401  (module-scoped fixture)
from .test_torch_multiday import assert_matches_jax, stage_entries, wave_cfg

DAYS = [0, 2]


def test_sharded_wave_matches_unsharded_and_jax(wave_season):  # noqa: F811
    ds = wave_season[0]
    base_stats, stats, jstats = [], [], []
    base = TM.interpolate_days(ds, DAYS, [0.15] * 2, wave_cfg("torch"), stats=base_stats,
                               device="cpu")
    sharding = cell_sharding(day_cell_mesh((2, 4), devices=["cpu"] * 8))
    got = TM.interpolate_days(ds, DAYS, [0.15] * 2, wave_cfg("torch"), stats=stats,
                              cell_sharding=sharding)
    for g, b in zip(got, base):
        g, b = g.to_reference_dict(), b.to_reference_dict()
        assert list(g) == list(b) and len(g) == 15
        for key, bv in b.items():
            np.testing.assert_array_equal(np.isnan(g[key]), np.isnan(bv), err_msg=key)
            if key.endswith(("_interp", "_interp_error", "_interp_smth", "_interp_error_smth")):
                np.testing.assert_allclose(g[key], bv, atol=1e-10, rtol=0, err_msg=key)
            else:
                np.testing.assert_allclose(g[key], bv, rtol=1e-10, atol=0, err_msg=key)
    fields = ("stage", "n", "cells", "iters_sum", "converged")
    assert [[e.get(f) for f in fields] for e in stats] == [
        [e.get(f) for f in fields] for e in base_stats]
    assert all(e["shards"] > 1 for e in stats if e["stage"] != "smooth")

    mesh = jax_day_cell_mesh((2, 4))
    ref = JM.interpolate_days(ds, DAYS, [0.15] * 2, wave_cfg("jax"), stats=jstats,
                              cell_sharding=NamedSharding(mesh, P(("days", "cells"))))
    assert_matches_jax(got, ref)
    assert stage_entries(stats) == stage_entries(jstats)
