"""The port's sharded day against the JAX package's sharded day, float64
on the CPU.

The JAX package's ``interpolate_daily`` over ``make_mesh()``'s 8 virtual
CPU devices (``tests/conftest.py``), as
``tests/test_pipeline.py::test_pipeline_sharded_matches_unsharded`` runs
it, against the port's day on 3 CPU shards, in the cases of
``test_torch_sharded.py``: its configuration as it is (``flat``) and with
the spatial seeding and the warm-start cascade on (``seeded``). All 15
fields with the same NaN cells, predictions within 1e-6 m, lZ and hypers
within 1e-5 relative (``test_torch_multiday.assert_matches_jax``), and the
same stage entries (names, N, cells and iteration sums).
"""

import pytest

from .test_pipeline import small_season  # noqa: F401  (module-scoped fixture)
from .test_torch_sharded import check_against_jax_sharded, runs  # noqa: F401


@pytest.mark.parametrize("case", ["flat", "seeded"])
def test_sharded_day_matches_jax_sharded(small_season, runs, case):  # noqa: F811
    check_against_jax_sharded(small_season, runs, case)
