"""Figure generation (reference C16).

A copy of ``optimalinterpolation_tpu/viz.py`` (which imports no JAX, but
the JAX package's ``__init__`` does), pinned equal to it by
``tests/test_torch_viz.py``. Rebuilds the plotting capabilities of the
reference notebooks with plain matplotlib, imported when a plot is drawn
(not with this module): where matplotlib is missing, a plot raises its
ImportError. No cartopy/Basemap:

  * :func:`plot_prior_posterior` — the prior-vs-posterior PDF figure of
    ``GP_example.ipynb`` cell-3 (paper Fig. 2): two Gaussians plus the
    interpolated value, for one grid cell.
  * :func:`plot_daily_field` — pan-Arctic daily map of any output field
    (freeboard, uncertainty, lZ, hyperparameters) on the stereographic
    x/y grid.
  * :func:`plot_training_footprint` — a cell's 300 km/9-day training
    neighbourhood colored by observation value, with the target cell and
    (optionally) SVGP inducing-point locations — the 3x3 footprint maps of
    ``dev/sparseGP_example.ipynb`` cell-6/cell-8.

All functions take an optional ``ax``/``path``; importing this module does
not require a display (callers should select the Agg backend for batch use).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = [
    "plot_prior_posterior",
    "plot_daily_field",
    "plot_training_footprint",
    "plot_hyperparameter_maps",
]


def _plt():
    import matplotlib

    if matplotlib.get_backend().lower() not in ("agg", "module://matplotlib_inline.backend_inline"):
        try:  # batch-safe default
            matplotlib.use("Agg", force=False)
        except Exception:
            pass
    import matplotlib.pyplot as plt

    return plt


def plot_prior_posterior(
    prior_mean: float,
    prior_std: float,
    post_mean: float,
    post_std: float,
    path: Optional[str] = None,
    ax=None,
):
    """Prior vs posterior predictive PDFs for one cell (paper Fig. 2)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 3.2))
    lo = min(prior_mean - 4 * prior_std, post_mean - 4 * post_std)
    hi = max(prior_mean + 4 * prior_std, post_mean + 4 * post_std)
    xs = np.linspace(lo, hi, 400)

    def pdf(m, s):
        return np.exp(-0.5 * ((xs - m) / s) ** 2) / (s * np.sqrt(2 * np.pi))

    ax.plot(xs, pdf(prior_mean, prior_std), label="prior", color="0.55", lw=1.5)
    ax.plot(xs, pdf(post_mean, post_std), label="posterior", color="C0", lw=1.8)
    ax.axvline(post_mean, color="C0", ls=":", lw=1)
    ax.set_xlabel("radar freeboard [m]")
    ax.set_ylabel("density")
    ax.legend(frameon=False)
    if path:
        ax.figure.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(ax.figure)
    return ax


def plot_daily_field(
    field: np.ndarray,  # (G, G)
    x: np.ndarray,
    y: np.ndarray,
    title: str = "radar freeboard [m]",
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    cmap: str = "viridis",
    path: Optional[str] = None,
    ax=None,
):
    """Pan-Arctic daily map on the stereographic grid (quicklook-style)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(5.4, 5))
    pm = ax.pcolormesh(x / 1e6, y / 1e6, field, shading="auto", cmap=cmap,
                       vmin=vmin, vmax=vmax)
    ax.set_aspect("equal")
    ax.set_xlabel("x [1000 km]")
    ax.set_ylabel("y [1000 km]")
    ax.set_title(title)
    ax.figure.colorbar(pm, ax=ax, shrink=0.85)
    if path:
        ax.figure.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(ax.figure)
    return ax


def plot_training_footprint(
    xy_train: np.ndarray,  # (n, 2) neighborhood coords [m]
    z_train: np.ndarray,  # (n,) observations
    cell_xy: Sequence[float],
    radius_m: float = 300e3,
    inducing_xy: Optional[np.ndarray] = None,
    path: Optional[str] = None,
    ax=None,
):
    """One cell's training neighbourhood (sparseGP_example cell-6/8 maps)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(4.6, 4.2))
    sc = ax.scatter(
        (xy_train[:, 0] - cell_xy[0]) / 1e3,
        (xy_train[:, 1] - cell_xy[1]) / 1e3,
        c=z_train, s=6, cmap="viridis",
    )
    th = np.linspace(0, 2 * np.pi, 200)
    r = radius_m / 1e3
    ax.plot(r * np.cos(th), r * np.sin(th), color="0.4", lw=1, ls="--")
    ax.plot([0], [0], marker="*", ms=14, color="crimson")
    if inducing_xy is not None:
        ax.scatter(
            (inducing_xy[:, 0] - cell_xy[0]) / 1e3,
            (inducing_xy[:, 1] - cell_xy[1]) / 1e3,
            marker="x", s=26, color="k", label="inducing",
        )
        ax.legend(frameon=False, loc="upper right")
    ax.set_aspect("equal")
    ax.set_xlabel("east offset [km]")
    ax.set_ylabel("north offset [km]")
    ax.figure.colorbar(sc, ax=ax, shrink=0.8, label="freeboard [m]")
    if path:
        ax.figure.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(ax.figure)
    return ax


def plot_hyperparameter_maps(
    hypers: dict,  # name -> (G, G), e.g. DailyResult.hypers
    x: np.ndarray,
    y: np.ndarray,
    path: Optional[str] = None,
):
    """Panel of the five per-cell hyperparameter fields (model diagnostics)."""
    plt = _plt()
    names = list(hypers)
    fig, axes = plt.subplots(1, len(names), figsize=(3.4 * len(names), 3.2))
    if len(names) == 1:
        axes = [axes]
    for ax, name in zip(axes, names):
        pm = ax.pcolormesh(x / 1e6, y / 1e6, hypers[name], shading="auto")
        ax.set_aspect("equal")
        ax.set_title(name)
        fig.colorbar(pm, ax=ax, shrink=0.75)
    if path:
        fig.savefig(path, dpi=130, bbox_inches="tight")
        plt.close(fig)
    return fig
