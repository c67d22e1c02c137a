"""NaN-aware Gaussian smoothing of hyperparameter fields.

PyTorch counterpart of ``optimalinterpolation_tpu/ops/smoothing.py``: the
reference's ``smooth()`` (``GPR_CS2S3.py:65-76``), which uses astropy's
``convolve(data, Gaussian2DKernel(std))``: clip at a physical vmax,
normalized NaN-interpolating Gaussian convolution, zeros -> field mean,
re-mask by sea-ice extent.

It runs in float64 on the CPU, whatever device the fit runs on: the five
(G, G) fields of a day are about 10 MFLOP, they are on the host between the
two passes anyway, and a float32 convolution on the card goes through cuDNN
in TF32 by default.

Astropy parity:
  * ``Gaussian2DKernel(std)`` support is 8 * std, rounded up to the next odd
    integer; the kernel is sampled at integer offsets and normalized to sum 1.
  * ``convolve`` treats NaN as missing: out = conv(data_0) / conv(finite),
    boundary zero-filled; pixels whose kernel support holds no valid data
    come out as exactly 0, which the reference then replaces by the field
    mean (``:74``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_kernel_2d", "nan_gaussian_smooth", "smooth_hyper_field"]


def _field(a) -> torch.Tensor:
    """A float64 CPU tensor of a (G, G) array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64)
    return torch.tensor(np.asarray(a, dtype=np.float64))


def gaussian_kernel_2d(std: float, dtype=torch.float64) -> torch.Tensor:
    """Odd-sized 2-D Gaussian tap matrix, normalized to sum 1."""
    half = int(4.0 * std)  # support = 8 * std -> radius 4 * std
    r = torch.arange(-half, half + 1, dtype=dtype)
    g1 = torch.exp(-0.5 * (r / std) ** 2)
    k = torch.outer(g1, g1)
    return k / k.sum()


def nan_gaussian_smooth(field, std: float = 1.0) -> torch.Tensor:
    """Normalized (NaN-interpolating) Gaussian convolution of a 2-D field,
    zero padding at the boundary. Pixels with no valid data under the kernel
    return 0 (the astropy behaviour the reference relies on at
    ``GPR_CS2S3.py:74``)."""
    field = _field(field)
    k = gaussian_kernel_2d(std)
    pad = k.shape[0] // 2
    finite = torch.isfinite(field)
    data0 = torch.where(finite, field, 0.0)
    both = torch.stack([data0, finite.to(field.dtype)])[:, None]  # (2, 1, G, G)
    num, den = F.conv2d(both, k[None, None], padding=pad)[:, 0]
    return torch.where(den > 0.0, num / torch.where(den > 0.0, den, 1.0), 0.0)


def smooth_hyper_field(field, vmax: float, sie_mask, std: float = 1.0) -> torch.Tensor:
    """The reference's ``smooth()`` (``GPR_CS2S3.py:65-76``):

      1. inf -> NaN;
      2. clip above ``vmax`` (the physical bound per hyperparameter,
         ``:303-307``);
      3. NaN-aware Gaussian convolution;
      4. exact zeros -> mean of the smoothed field (after step 3 it has no
         NaN, only zeros outside coverage, so the reference's nanmean is the
         plain mean, zeros included);
      5. NaN again where ``sie_mask`` is NaN.
    """
    f = _field(field)
    f = torch.where(torch.isinf(f), torch.nan, f)
    f = torch.where(f > vmax, vmax, f)
    s = nan_gaussian_smooth(f, std=std)
    s = torch.where(s != 0.0, s, s.mean())
    return torch.where(torch.isnan(_field(sie_mask)), torch.nan, s)
