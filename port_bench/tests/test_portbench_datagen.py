"""The benchmark's frozen season generator against the port's, and the
share of cells one card runs."""

import os
import pickle

import numpy as np
import portbench_tiny  # noqa: F401  (puts the repository on the path)
import pytest

from port_bench.datagen import fields as F
from port_bench.datagen import season as S
from port_bench.reference import gather as G


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_frozen_season_equals_the_ports(tmp_path):
    from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season

    truth, dates = make_synthetic_season(str(tmp_path / "port"), grid_res_km=200, n_days=6,
                                         tracks_per_day=(10, 3, 8, 8), noise_std=0.1,
                                         seed=31415)
    season = S.make_season(200, 6, (10, 3, 8, 8), 0.1, 31415)
    S.write_season(season, str(tmp_path / "bench"))
    assert season.obs.shape == (40, 40, 4, 6)
    np.testing.assert_array_equal(season.truth, truth)
    assert season.dates == dates
    for name in sorted(os.listdir(tmp_path / "bench")):
        a, b = tmp_path / "bench" / name, tmp_path / "port" / name
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
            continue
        got, want = _load(a), _load(b)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_share_keeps_a_quarter_of_each_bucket():
    """Over many seeds, each bucket keeps 1/4 of its cells to within four
    standard deviations of the binomial draw."""
    season = S.make_season(200, 12, (10, 3, 8, 8), 0.1, 2718)
    gi, gj, _, _ = G.window_points(season.obs, season.x, season.y, 2, 9)
    per_cell = np.zeros(season.x.shape, np.int64)
    np.add.at(per_cell, (gi, gj), 1)
    counts = G.neighbour_counts(per_cell, G.disc_offsets(season.x, season.y, 600e3))
    ice = season.sic[:, :, 6] >= S.SIE_THRESHOLD
    buckets = (128, 256, 512)
    caps = np.array([G.bucket_of(int(c), buckets) for c in counts[ice]])
    kept = {b: 0 for b in buckets}
    for seed in range(40):
        (rng,) = F.streams(seed, 1)
        share = F.share_mask(season.x.shape, 0.25, rng)[ice]
        for b in buckets:
            kept[b] += int(share[caps == b].sum())
    for b in buckets:
        n = 40 * int((caps == b).sum())
        assert n > 0
        sd = np.sqrt(n * 0.25 * 0.75)
        assert abs(kept[b] - 0.25 * n) < 4 * sd, (b, kept[b], n)


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 9_000_000_000])
def test_draws_repeat_for_a_seed_and_keep_their_size(seed):
    x, y = S.grid_coords(200)
    waves = [[0, 2500], [60, 4000], [120, 6000]]
    a = F.hyper_fields(x, y, {n: 1.0 for n in F.HYPER_NAMES}, 0.25, waves, F.streams(seed, 3)[1])
    b = F.hyper_fields(x, y, {n: 1.0 for n in F.HYPER_NAMES}, 0.25, waves, F.streams(seed, 3)[1])
    for n in F.HYPER_NAMES:
        np.testing.assert_array_equal(a[n], b[n])
        assert np.all(np.abs(np.log(a[n])) <= 0.25 + 1e-12)
