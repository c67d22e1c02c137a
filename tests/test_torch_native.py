"""The port's C++ host data plane (``optimalinterpolation_tpu_torch/native``)
against the JAX package's copy of it and against SciPy / NumPy: the
grid-hash radius search (CSR equal to JAX's and to cKDTree's lists) and the
``.proc`` parser (bit-equal to JAX's, equal to ``np.genfromtxt`` at rtol
1e-9 with NaN tokens). The library builds with ``g++`` at first use into
the port's ``native/_build/`` only, and a failed build raises.
"""

import os

import numpy as np
import pytest
from scipy.spatial import cKDTree

from optimalinterpolation_tpu import native as jnative
from optimalinterpolation_tpu_torch import native


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's library. Its ``_load`` remembers a failure, and a
    worker that loaded it while another worker's ``make`` was writing it
    fails once; the finished file loads on a second try."""
    if not jnative.available():
        jnative._tried = False
    assert jnative.available()
    return jnative


def _kdtree_csr(pts, cells, r):
    lists = cKDTree(pts).query_ball_point(cells, r=r) if len(cells) else []
    offsets = np.zeros(len(cells) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(v) for v in lists])
    flat = np.concatenate([np.asarray(v, dtype=np.int64) for v in lists] + [np.empty(0, np.int64)])
    return offsets, flat


@pytest.mark.parametrize("n,m,r", [(4000, 300, 3e5), (20000, 50, 1e6), (1000, 0, 3e5)])
def test_radius_neighbors_matches_jax_and_kdtree(jax_native, n, m, r):
    rng = np.random.default_rng(n + m)
    pts = rng.uniform(0, 8e6, (n, 2))
    cells = rng.uniform(0, 8e6, (m, 2))
    off, idx = native.radius_neighbors(pts, cells, r)
    j_off, j_idx = jax_native.radius_neighbors(pts, cells, r)
    np.testing.assert_array_equal(off, j_off)
    np.testing.assert_array_equal(idx, j_idx)
    k_off, k_idx = _kdtree_csr(pts, cells, r)
    np.testing.assert_array_equal(off, k_off)
    np.testing.assert_array_equal(idx, k_idx)
    assert off.dtype == idx.dtype == np.int64 and len(off) == m + 1


def test_radius_neighbors_empty_cell_and_exact_radius(jax_native):
    pts = np.array([[0.0, 0.0], [10.0, 0.0], [5.0, 5.0], [3.0, 4.0]])
    cells = np.array([[100.0, 100.0], [0.0, 0.0], [5.0, 0.0]])
    off, idx = native.radius_neighbors(pts, cells, 5.0)
    # far cell: none; origin: itself and (3, 4) at exactly 5; the midpoint:
    # both ends and (5, 5), each exactly at 5, and (3, 4) inside
    assert np.diff(off).tolist() == [0, 2, 4]
    assert idx.tolist() == [0, 3, 0, 1, 2, 3]
    for got, ref in zip((off, idx), jax_native.radius_neighbors(pts, cells, 5.0)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip((off, idx), _kdtree_csr(pts, cells, 5.0)):
        np.testing.assert_array_equal(got, ref)


def _proc_rows(rng, n):
    cols = rng.normal(size=(n, 8)) * [90, 40, 1, 1, 0.3, 1, 1, 1]
    cols[:, 7] = rng.choice([1, 2], n)
    return cols


def test_parse_proc_matches_jax_and_genfromtxt(jax_native, tmp_path):
    rng = np.random.default_rng(8)
    rows = _proc_rows(rng, 300)
    lines = [" ".join(f"{v:.12g}" for v in row) for row in rows]
    for i in (3, 77, 200):  # NaN tokens, as some GPOD files carry
        lines[i] = " ".join(lines[i].split()[:4] + ["nan"] + lines[i].split()[5:])
    path = tmp_path / "t.proc"
    path.write_text("\n".join(lines) + "\n")
    got = native.parse_proc(str(path))
    assert got.shape == (300, 8) and got.dtype == np.float64
    np.testing.assert_array_equal(got, jax_native.parse_proc(str(path)))
    np.testing.assert_allclose(got, np.genfromtxt(path), rtol=1e-9, equal_nan=True)
    assert np.isnan(got[[3, 77, 200], 4]).all()


def test_parse_proc_tabs_no_trailing_newline(tmp_path):
    path = tmp_path / "t.proc"
    path.write_text("1\t2.5 3\r\n\n4 5e-3\t-6")
    np.testing.assert_array_equal(native.parse_proc(str(path)), [[1, 2.5, 3], [4, 5e-3, -6]])


@pytest.mark.parametrize("text", ["1 2 3\n4 5\n", ""])
def test_parse_proc_ragged_or_empty_raises(tmp_path, text):
    path = tmp_path / "bad.proc"
    path.write_text(text)
    with pytest.raises(RuntimeError, match="native parse failed"):
        native.parse_proc(str(path))


def test_build_writes_only_under_the_ports_build_dir():
    jax_dir = os.path.dirname(jnative.__file__)
    before = sorted(os.listdir(jax_dir))
    lib = native.build()
    assert lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent == native.SOURCE.parent
    assert lib.name.startswith("liboi_native_") and lib.suffix == ".so" and lib.exists()
    assert sorted(os.listdir(jax_dir)) == before
    assert native.build() == lib  # a second call finds it


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fno-such-flag-oi",))
    with pytest.raises(RuntimeError, match="(?s)failed on oi_native.cpp.*no-such-flag-oi"):
        native.build()
    assert not any(p.suffix in (".so", ".tmp") for p in (tmp_path / "_build").iterdir())
