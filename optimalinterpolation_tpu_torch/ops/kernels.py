"""Stationary covariance functions with per-dimension length-scales.

PyTorch counterpart of ``optimalinterpolation_tpu/ops/kernels.py``: the
anisotropic Matern-1/2, 3/2, 5/2 and squared-exponential covariances of the
reference's ``SGPkernel`` (``GPR_CS2S3.py:78-105``), over (x, y, t) inputs
pre-scaled by their length-scales. Functions take any leading batch shape:
``x (..., n, d)``, ``ell (..., d)``, ``sf2 (...)``.

  * Squared distances are per-dimension broadcast differences: exact in
    float32. The |a|^2 + |b|^2 - 2 a.b expansion cancels catastrophically.
  * The self-distance diagonal is exactly zero, so k(x, x) = sf2 exactly.
  * dtype-preserving: float64 on the CPU for parity tests, float32 on the
    card in production.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

__all__ = ["Kernel", "kernel_matrix", "cross_kernel"]


class Kernel(str, enum.Enum):
    """Supported stationary kernel families."""

    MATERN12 = "matern12"
    MATERN32 = "matern32"
    MATERN52 = "matern52"
    SE = "se"


# nu^2 of r = sqrt(nu^2 d2) per family (pallas_gp.py::_NU2).
_NU2 = {Kernel.MATERN12: 1.0, Kernel.MATERN32: 3.0, Kernel.MATERN52: 5.0}


def _shape_fn(kind: Kernel, d2: torch.Tensor) -> torch.Tensor:
    """k / sf2 as a function of the scaled squared distance d2
    (``pallas_gp.py::_shape_fn``; K2 evaluates the same expressions).
    Works in place on temporaries: at N = 4096 each is a (B, N, N) buffer."""
    kind = Kernel(kind)
    if kind is Kernel.SE:
        return torch.exp(-0.5 * d2)
    r = (_NU2[kind] * d2).clamp_min_(0.0).sqrt_()
    e = torch.exp(-r)
    if kind is Kernel.MATERN12:
        return e
    if kind is Kernel.MATERN32:
        return r.add_(1.0).mul_(e)
    return (r * r).div_(3.0).add_(r).add_(1.0).mul_(e)  # MATERN52


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances, (..., n, d) x (..., m, d) -> (..., n, m),
    summed per dimension from broadcast differences."""
    acc = None
    for k in range(a.shape[-1]):
        diff = (a[..., :, k, None] - b[..., None, :, k]).square_()
        acc = diff if acc is None else acc.add_(diff)
    return acc


def _masked(k: torch.Tensor, mask: Optional[torch.Tensor], cols: bool) -> torch.Tensor:
    if mask is None:
        return k
    m = mask.to(k.dtype)
    k.mul_(m[..., :, None])
    return k.mul_(m[..., None, :]) if cols else k


def kernel_matrix(
    x: torch.Tensor,
    ell: torch.Tensor,
    sf2: torch.Tensor,
    kind: Kernel = Kernel.MATERN32,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gram matrix K(x, x), shape (..., n, n); rows and columns of padded
    points (``mask`` 0) are zero. Parity target: ``SGPkernel(x, ell, sigma)``
    (``GPR_CS2S3.py:92-94``) for ``kind=MATERN32``."""
    xs = x / ell[..., None, :]
    d2 = _sqdist(xs, xs)
    d2.diagonal(dim1=-2, dim2=-1).zero_()
    k = _shape_fn(kind, d2).mul_(torch.as_tensor(sf2)[..., None, None])
    return _masked(k, mask, cols=True)


def cross_kernel(
    x: torch.Tensor,
    xstar: torch.Tensor,
    ell: torch.Tensor,
    sf2: torch.Tensor,
    kind: Kernel = Kernel.MATERN32,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cross-covariance K(x, x*), shape (..., n, m); rows of padded points
    are zero. Parity target: ``SGPkernel(x, xs=xs, ...)``
    (``GPR_CS2S3.py:100-101``)."""
    e = ell[..., None, :]
    k = _shape_fn(kind, _sqdist(x / e, xstar / e))
    k.mul_(torch.as_tensor(sf2)[..., None, None])
    return _masked(k, mask, cols=False)
