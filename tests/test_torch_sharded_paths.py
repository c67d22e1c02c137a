"""The port's sharded day (``cell_sharding``) seeded and chained, float64
on the CPU.

Cases, helpers and tolerances of ``test_torch_sharded.py``: the seeded day
(spatial seeding and the warm-start cascade) and the day chained from its
hypers against the unsharded port, each on 3 and on 16 CPU shards. The Adam
day is in ``test_torch_sharded_adam.py``, the ``--devices`` CLI in
``test_torch_sharded_cli.py``.
"""

import pytest

from .test_pipeline import small_season  # noqa: F401  (the fixture of ``runs``)
from .test_torch_sharded import check_sharded_day, runs  # noqa: F401


@pytest.mark.parametrize("n_shards", [3, 16])
@pytest.mark.parametrize("case", ["seeded", "chained"])
def test_sharded_day_matches_unsharded(runs, case, n_shards):  # noqa: F811
    check_sharded_day(runs, case, n_shards)
