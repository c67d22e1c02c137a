"""A wave on the default path, spatial seeding and the subsample cascade,
through both packages (float64, CPU; setup and tolerances of
``test_torch_multiday.py``).

The seed pass runs once over the wave's seed sublattices, and the shuffle
that makes a row's prefixes subsamples draws one permutation per row over
each combined bucket, in wave order. Seeded waves are therefore not equal
to serial days; the JAX package's wave on the same inputs is the
reference, stage by stage. As ``tests/test_multiday.py`` asks, the fields
are also finite and track the synthetic truth.
"""

import numpy as np

from optimalinterpolation_tpu.pipeline import multiday as JM
from optimalinterpolation_tpu_torch.pipeline import multiday as TM

from .test_multiday import wave_season  # noqa: F401  (module-scoped fixture)
from .test_torch_multiday import assert_matches_jax, stage_entries, wave_cfg


# tests/test_multiday.py's seeded config with two changes, so that both
# phases run: seed stride 8, whose sublattice [4::8, 4::8] meets the
# thinned active set [::4, ::4] in >= 8 cells a day (stride 3 leaves fewer,
# and the seed pass is skipped); and a cascade floor of 64 for seeded cells
# (the default 512 exceeds these buckets).
_SEEDED = dict(warmstart_n=64, spatial_seed_stride=8, seed_opt_n=64, warmstart_n_seeded=64)


def test_wave_seeding_and_cascade_run(wave_season):  # noqa: F811
    ds, truth, _ = wave_season
    days = [0, 1]
    tstats, jstats = [], []
    res = TM.interpolate_days(ds, days, [0.15, 0.15], wave_cfg("torch", **_SEEDED),
                              stats=tstats, device="cpu")
    for day, r in zip(days, res):
        active = np.isfinite(ds.sie[:, :, day + 4])
        assert np.isfinite(r.interp_smth[active]).mean() > 0.9
        err = r.interp_smth[active] - truth[day + 4][active]
        assert np.sqrt(np.nanmean(err**2)) < 0.06
    stages = [e["stage"] for e in tstats]
    assert stages[0] == "seed:opt" and "seed:seed:opt" not in stages
    assert "cascade" in stages and stages.index("cascade") < stages.index("opt")

    ref = JM.interpolate_days(ds, days, [0.15, 0.15], wave_cfg("jax", **_SEEDED), stats=jstats)
    assert stage_entries(tstats) == stage_entries(jstats)
    assert_matches_jax(res, ref)
