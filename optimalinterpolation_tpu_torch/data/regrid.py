"""Nearest-neighbour fill of NaN holes in a gridded field.

A copy of ``nearest_fill`` from ``optimalinterpolation_tpu/data/regrid.py``
(numpy and SciPy's kd-tree only), kept here because importing anything from
that package imports JAX; ``tests/test_torch_data.py`` pins the two equal.
The daily pipeline uses it to spread the seed cells' optimized
hyperparameters, and a previous day's, over the grid as starting points.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.spatial import cKDTree

__all__ = ["nearest_fill"]


def nearest_fill(
    field: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    valid_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Fill NaNs with the nearest finite value (the reference's NaN fill).

    ``valid_mask`` restricts which NaN pixels get filled (e.g. ocean only);
    pixels outside it stay NaN.
    """
    gx = x if np.ndim(x) == 2 else np.meshgrid(x, y)[0]
    gy = y if np.ndim(y) == 2 else np.meshgrid(x, y)[1]
    finite = np.isfinite(field)
    if not finite.any():
        return field.copy()
    holes = ~finite if valid_mask is None else (~finite) & valid_mask
    if not holes.any():
        return field.copy()
    tree = cKDTree(np.column_stack([gx[finite], gy[finite]]))
    _, idx = tree.query(np.column_stack([gx[holes], gy[holes]]))
    out = field.copy()
    out[holes] = field[finite][idx]
    return out
