"""Training-vector construction from a T-day observation window.

Vectorized rebuild of the reference's flatten loops
(``GPR_CS2S3.py:223-241``): every finite
observation in the (G, G, S, T) window becomes one training point
(x, y, t, z). The reference concatenates per-satellite lists; point ordering
is irrelevant to the GP (the Gram matrix is permutation-covariant), so we use
a single vectorized ``nonzero`` instead.

Copy of ``optimalinterpolation_tpu/data/window.py``, kept
until the JAX package's ``__init__`` is lazy (importing any module of it
imports jax today).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TrainingVectors", "flatten_window"]


@dataclasses.dataclass
class TrainingVectors:
    x: np.ndarray  # (n,) projected x [m]
    y: np.ndarray  # (n,) projected y [m]
    t: np.ndarray  # (n,) day index within the window [0, T)
    z: np.ndarray  # (n,) observed freeboard [m]

    @property
    def xyt(self) -> np.ndarray:
        return np.stack([self.x, self.y, self.t], axis=1)

    @property
    def xy(self) -> np.ndarray:
        return np.stack([self.x, self.y], axis=1)

    def __len__(self):
        return len(self.z)


def flatten_window(
    sat_window: np.ndarray,  # (G, G, S, T) freeboard window, NaN = missing
    grid_x: np.ndarray,  # (G, G)
    grid_y: np.ndarray,  # (G, G)
) -> TrainingVectors:
    """All finite observations in the window as flat training vectors."""
    finite = np.isfinite(sat_window)
    gi, gj, _, ti = np.nonzero(finite)
    return TrainingVectors(
        x=np.ascontiguousarray(grid_x[gi, gj]),
        y=np.ascontiguousarray(grid_y[gi, gj]),
        t=ti.astype(grid_x.dtype),
        z=np.ascontiguousarray(sat_window[finite]),
    )
