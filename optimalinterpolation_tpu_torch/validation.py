"""Validation against independent point observations (reference C17).

The reference reserves ``OIB/`` for Operation IceBridge airborne validation
data but ships only a placeholder (``OIB/temp.txt``); this module supplies
the machinery that directory implies: colocate point measurements (x, y,
date, value) with daily interpolated fields and report the standard skill
metrics (bias, RMSE, correlation, coverage, and the uncertainty-consistency
z-score the per-cell posterior std enables).

Copy of ``optimalinterpolation_tpu/validation.py`` (numpy only), kept
because importing any module of that package imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

__all__ = ["PointObs", "ValidationStats", "colocate", "validate_fields"]


@dataclasses.dataclass
class PointObs:
    """Point validation data (e.g. an OIB flight line), projected to grid
    coordinates."""

    x: np.ndarray  # (n,) [m]
    y: np.ndarray  # (n,) [m]
    date: np.ndarray  # (n,) str/entry per point, 'YYYYMMDD'
    value: np.ndarray  # (n,) [m]


@dataclasses.dataclass
class ValidationStats:
    n: int
    bias: float  # mean(interp - obs)
    rmse: float
    corr: float
    coverage: float  # fraction of points landing on a finite grid cell
    mean_z: float  # mean |interp - obs| / predicted sigma (uncertainty check)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _cell_index(coord: np.ndarray, axis: np.ndarray) -> np.ndarray:
    """Nearest grid index along one axis (axis = 1-D cell coordinates)."""
    step = axis[1] - axis[0]
    idx = np.round((coord - axis[0]) / step).astype(np.int64)
    return np.clip(idx, 0, len(axis) - 1)


def colocate(
    obs: PointObs,
    field: np.ndarray,  # (G, G) for one date
    x_axis: np.ndarray,  # (G,) grid x coordinates (axis 0 of field)
    y_axis: np.ndarray,  # (G,) grid y coordinates (axis 1 of field)
    date: str,
) -> tuple[np.ndarray, np.ndarray]:
    """(interp_at_points, obs_values) for the points matching ``date``."""
    sel = np.asarray(obs.date) == date
    ix = _cell_index(np.asarray(obs.x)[sel], x_axis)
    iy = _cell_index(np.asarray(obs.y)[sel], y_axis)
    return field[ix, iy], np.asarray(obs.value)[sel]


def validate_fields(
    obs: PointObs,
    fields: Mapping[str, np.ndarray],  # date -> (G, G) interpolated field
    x_axis: np.ndarray,
    y_axis: np.ndarray,
    uncertainties: Mapping[str, np.ndarray] | None = None,
) -> ValidationStats:
    """Skill of a set of daily fields against the point observations."""
    pred, meas, sig = [], [], []
    for date, field in fields.items():
        p, o = colocate(obs, field, x_axis, y_axis, date)
        pred.append(p)
        meas.append(o)
        if uncertainties is not None and date in uncertainties:
            s, _ = colocate(obs, uncertainties[date], x_axis, y_axis, date)
            sig.append(s)
    pred = np.concatenate(pred) if pred else np.empty(0)
    meas = np.concatenate(meas) if meas else np.empty(0)
    finite = np.isfinite(pred) & np.isfinite(meas)
    coverage = float(finite.mean()) if pred.size else 0.0
    p, o = pred[finite], meas[finite]
    if p.size == 0:
        return ValidationStats(0, np.nan, np.nan, np.nan, coverage, np.nan)
    err = p - o
    corr = float(np.corrcoef(p, o)[0, 1]) if p.size > 1 else np.nan
    mean_z = np.nan
    if sig:
        s = np.concatenate(sig)[finite]
        good = np.isfinite(s) & (s > 0)
        if good.any():
            mean_z = float(np.mean(np.abs(err[good]) / s[good]))
    return ValidationStats(
        n=int(p.size),
        bias=float(err.mean()),
        rmse=float(np.sqrt(np.mean(err**2))),
        corr=corr,
        coverage=coverage,
        mean_z=mean_z,
    )
