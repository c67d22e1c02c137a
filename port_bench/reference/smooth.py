"""The reference's ``smooth()`` of a hyperparameter field
(``GPR_CS2S3.py:65-76``), in numpy: clip at the physical bound, astropy's
NaN-interpolating normalised convolution with ``Gaussian2DKernel(std)``
(support 8 std rounded to the next odd width, zero boundary), exact zeros to
the smoothed field's mean, NaN again outside the ice. The Gaussian is
separable, so the convolution runs along one axis and then the other.
"""

from __future__ import annotations

import numpy as np


def _taps(std: float, dtype) -> np.ndarray:
    half = int(4.0 * std)
    r = np.arange(-half, half + 1, dtype=dtype)
    g = np.exp(-0.5 * (r / std) ** 2)
    return g / g.sum()


def _conv_axis(a: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    half = len(taps) // 2
    pad = [(0, 0), (0, 0)]
    pad[axis] = (half, half)
    p = np.pad(a, pad)
    out = np.zeros_like(a)
    n = a.shape[axis]
    for k, w in enumerate(taps):
        sl = [slice(None), slice(None)]
        sl[axis] = slice(k, k + n)
        out += w * p[tuple(sl)]
    return out


def smooth_field(field: np.ndarray, vmax: float, ice: np.ndarray, std: float,
                 dtype=np.float64) -> np.ndarray:
    """The smoothed field; ``ice`` is True where the day's cell is active."""
    f = np.asarray(field, dtype)
    f = np.where(np.isinf(f), np.nan, f)
    f = np.where(f > vmax, dtype(vmax), f)
    finite = np.isfinite(f)
    taps = _taps(std, dtype)
    num = _conv_axis(_conv_axis(np.where(finite, f, 0.0).astype(dtype), taps, 0), taps, 1)
    den = _conv_axis(_conv_axis(finite.astype(dtype), taps, 0), taps, 1)
    s = np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0).astype(dtype)
    s = np.where(s != 0.0, s, s.mean())
    return np.where(ice, s, np.nan)
