"""The port's Adam day sharded (``cell_sharding``) against the unsharded
Adam day, on 3 and on 16 CPU shards, float64 on the CPU (the case, helpers
and tolerances of ``test_torch_sharded.py``).
"""

import pytest

from .test_pipeline import small_season  # noqa: F401  (the fixture of ``runs``)
from .test_torch_sharded import check_sharded_day, runs  # noqa: F401


@pytest.mark.parametrize("n_shards", [3, 16])
@pytest.mark.parametrize("case", ["adam"])
def test_sharded_day_matches_unsharded(runs, case, n_shards):  # noqa: F811
    check_sharded_day(runs, case, n_shards)
