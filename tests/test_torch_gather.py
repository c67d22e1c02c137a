"""The port's neighbourhood gather (native grid hash + array fill) gives the
JAX package's buckets bit for bit, and those of its own plain version (the
kd-tree lists filled cell by cell, as the JAX gather fills them).

Seeded synthetic windows: points scattered over a box with a denser patch,
so the production buckets (512-4096) all fill; a small bucket menu forces
the nearest-``cap`` truncation of the oversize cells; an odd
``batch_multiple`` pads each bucket with rows of ``cell_index`` -1.
"""

import numpy as np
import pytest

from optimalinterpolation_tpu.data import neighbors as JN
from optimalinterpolation_tpu.data.window import TrainingVectors as JTrain
from optimalinterpolation_tpu_torch.data import neighbors as TN
from optimalinterpolation_tpu_torch.data.window import TrainingVectors as TTrain

FIELDS = ("x", "z", "mask", "xstar", "cell_index")


def _window(seed: int, n: int = 12000, m: int = 400):
    rng = np.random.default_rng(seed)
    dense = rng.normal(1.2e6, 2e5, (n // 3, 2))
    xy = np.concatenate([rng.uniform(0, 2.4e6, (n - n // 3, 2)), dense])
    t = rng.integers(0, 9, n).astype(np.float64)
    z = rng.normal(0.2, 0.1, n)
    cells = rng.uniform(0, 2.4e6, (m, 2))
    cells[:5] = [[-5e6, -5e6]] * 5  # far outside: no neighbour at all
    return xy, t, z, cells


def _assert_same(got, ref):
    assert [b.capacity for b in got] == [b.capacity for b in ref] and len(ref) > 0
    for g, r in zip(got, ref):
        assert g.n_valid_cells == r.n_valid_cells
        for name in FIELDS:
            a, b = getattr(g, name), getattr(r, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=f"N={r.capacity} {name}")


CASES = {
    "production buckets, float32": dict(buckets=(512, 1024, 2048, 4096), dtype=np.float32,
                                        batch_multiple=8),
    "oversize truncation, odd padding": dict(buckets=(64, 128, 256), dtype=np.float32,
                                             batch_multiple=5),
    "float64, one bucket": dict(buckets=(1024,), dtype=np.float64, batch_multiple=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gather_matches_jax_bit_for_bit(case):
    xy, t, z, cells = _window(3)
    kw = dict(t_star=4.0, radius_m=3e5, **CASES[case])
    ref = JN.gather_neighborhoods(JTrain(xy[:, 0], xy[:, 1], t, z), cells, **kw)
    got = TN.gather_neighborhoods(TTrain(xy[:, 0], xy[:, 1], t, z), cells, **kw)
    _assert_same(got, ref)
    if case.startswith("oversize"):
        lists = TN._neighbor_lists_kdtree(TTrain(xy[:, 0], xy[:, 1], t, z), cells, 3e5)
        assert sum(len(v) > 256 for v in lists) > 10  # the truncation really ran
        assert (ref[-1].cell_index == -1).any()


@pytest.mark.parametrize("case", list(CASES))
def test_gather_matches_plain_version(case):
    xy, t, z, cells = _window(4)
    train = TTrain(xy[:, 0], xy[:, 1], t, z)
    kw = dict(t_star=4.0, radius_m=3e5, **CASES[case])
    _assert_same(TN.gather_neighborhoods(train, cells, **kw), TN._gather_plain(train, cells, **kw))


def test_gather_fills_across_chunks(monkeypatch):
    """Rows split over several fill chunks (one row longer than a chunk)
    give the arrays of one chunk."""
    xy, t, z, cells = _window(5)
    train = TTrain(xy[:, 0], xy[:, 1], t, z)
    kw = dict(t_star=4.0, radius_m=3e5)
    ref = TN.gather_neighborhoods(train, cells, **kw)
    monkeypatch.setattr(TN, "_FILL_CHUNK", 700)
    _assert_same(TN.gather_neighborhoods(train, cells, **kw), ref)


def test_gather_with_no_neighbours_anywhere():
    """Cells far from every point land in the smallest bucket with empty rows."""
    xy, t, z, _ = _window(6, n=500)
    train = TTrain(xy[:, 0], xy[:, 1], t, z)
    cells = np.array([[-1e7, -1e7], [-2e7, 3e7]])
    (b,) = TN.gather_neighborhoods(train, cells, t_star=4.0, radius_m=3e5)
    assert b.capacity == 512 and b.n_valid_cells == 2 and len(b) == 8
    assert b.mask.sum() == 0
    np.testing.assert_array_equal(b.cell_index, [0, 1] + [-1] * 6)
