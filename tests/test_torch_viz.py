"""The port's ``viz.py`` (a copy) against the JAX package's: each of the
four plots drawn by both on the same inputs, every artist's data equal
(line data, scatter offsets and colours, mesh arrays, limits, labels), and
both write a PNG."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from optimalinterpolation_tpu import viz as jviz  # noqa: E402
from optimalinterpolation_tpu_torch import viz as tviz  # noqa: E402


def _artists(fig) -> list:
    """Every axes' lines, collections and labels as comparable arrays."""
    out = []
    for ax in fig.axes:
        out.append(("labels", ax.get_xlabel(), ax.get_ylabel(), ax.get_title()))
        out.append(("limits", *ax.get_xlim(), *ax.get_ylim()))
        for line in ax.get_lines():
            out.append(("line", np.asarray(line.get_xdata(), float),
                        np.asarray(line.get_ydata(), float), line.get_color()))
        for c in ax.collections:
            arr = c.get_array()
            out.append(("collection", type(c).__name__, np.asarray(c.get_offsets()),
                        None if arr is None else np.ma.filled(np.asarray(arr, float), np.nan)))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y) and x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            if isinstance(u, np.ndarray):
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v


def _inputs():
    rng = np.random.default_rng(5)
    g = 12
    x, y = np.meshgrid(np.arange(g) * 25e3, np.arange(g) * 25e3, indexing="ij")
    field = rng.normal(0.2, 0.05, (g, g))
    field[3, 4] = np.nan
    xy = rng.uniform(-3e5, 3e5, (50, 2)) + [1e6, 2e6]
    inducing = rng.uniform(-3e5, 3e5, (6, 2)) + [1e6, 2e6]
    return g, x, y, field, xy, rng.normal(0.2, 0.05, 50), inducing


@pytest.mark.parametrize("plot", ["prior_posterior", "daily_field", "footprint",
                                  "footprint_inducing", "hyperparameter_maps"])
def test_plots_equal(plot, tmp_path):
    g, x, y, field, xy, z, ind = _inputs()
    calls = {
        "prior_posterior": lambda m: m.plot_prior_posterior(0.15, 0.2, 0.31, 0.02).figure,
        "daily_field": lambda m: m.plot_daily_field(field, x, y, vmin=0.0, vmax=0.5).figure,
        "footprint": lambda m: m.plot_training_footprint(xy, z, (1e6, 2e6)).figure,
        "footprint_inducing": lambda m: m.plot_training_footprint(
            xy, z, (1e6, 2e6), radius_m=250e3, inducing_xy=ind).figure,
        "hyperparameter_maps": lambda m: m.plot_hyperparameter_maps(
            {"ell_x": field, "sf2": field * 0.1}, x, y),
    }
    ref, got = calls[plot](jviz), calls[plot](tviz)
    _same(_artists(got), _artists(ref))
    plt.close("all")


def test_plots_write_pngs(tmp_path):
    g, x, y, field, xy, z, ind = _inputs()
    for mod in (jviz, tviz):
        p1, p2 = tmp_path / f"{mod.__name__}_a.png", tmp_path / f"{mod.__name__}_b.png"
        mod.plot_prior_posterior(0.15, 0.2, 0.31, 0.02, path=str(p1))
        mod.plot_hyperparameter_maps({"sn2": field}, x, y, path=str(p2))
        assert p1.read_bytes()[:4] == b"\x89PNG" and p2.read_bytes()[:4] == b"\x89PNG"


def test_module_source_is_a_copy():
    """Apart from its docstring, the port's module is the JAX package's."""
    def body(mod):
        with open(mod.__file__) as f:
            text = f.read()
        return text[text.index('"""', 3) + 3:]

    assert body(tviz) == body(jviz)
