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
  * :func:`kernel_matrix` works in place on its temporaries (at N = 4096
    each is a (B, N, N) buffer) unless an input requires a gradient: then it
    takes an out-of-place form that autograd can differentiate, with a
    finite gradient at zero distance (``kernels.py::_safe_sqrt``).
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


def _shape_fn_autograd(kind: Kernel, d2: torch.Tensor) -> torch.Tensor:
    """:func:`_shape_fn` out of place, and with sqrt's gradient finite (zero)
    at d2 = 0, for the objective's autograd gradient."""
    kind = Kernel(kind)
    if kind is Kernel.SE:
        return torch.exp(-0.5 * d2)
    zero = d2 <= 0.0
    r = torch.where(zero, 0.0, torch.sqrt(_NU2[kind] * torch.where(zero, 1.0, d2)))
    e = torch.exp(-r)
    if kind is Kernel.MATERN12:
        return e
    if kind is Kernel.MATERN32:
        return (1.0 + r) * e
    return (1.0 + r + r * r / 3.0) * e  # MATERN52


def _dlogell_weight(kind: Kernel, d2: torch.Tensor) -> torch.Tensor:
    """w(d2) with d k / d log ell_d = sf2 * w(d2) * dq_d^2
    (``pallas_gp.py::_dlogell_weight``; K3 evaluates the same expressions).
    With r = sqrt(nu2 d2): Matern-1/2 e^-r / r (0 at r = 0, where dq = 0
    too), Matern-3/2 3 e^-r, Matern-5/2 (5/3) e^-r (1 + r), SE e^(-d2/2)."""
    kind = Kernel(kind)
    if kind is Kernel.SE:
        return torch.exp(-0.5 * d2)
    r = (_NU2[kind] * d2).clamp_min(0.0).sqrt()
    e = torch.exp(-r)
    if kind is Kernel.MATERN12:
        pos = r > 0.0
        return torch.where(pos, e / torch.where(pos, r, 1.0), 0.0)
    if kind is Kernel.MATERN32:
        return 3.0 * e
    return (5.0 / 3.0) * e * (1.0 + r)  # MATERN52


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
    sf2 = torch.as_tensor(sf2)
    if torch.is_grad_enabled() and (x.requires_grad or ell.requires_grad or sf2.requires_grad):
        d2 = sum(
            (xs[..., :, None, k] - xs[..., None, :, k]).square() for k in range(x.shape[-1])
        )
        d2 = d2 * (1.0 - torch.eye(x.shape[-2], dtype=x.dtype, device=x.device))
        k = sf2[..., None, None] * _shape_fn_autograd(kind, d2)
        if mask is not None:
            m = mask.to(k.dtype)
            k = k * m[..., :, None] * m[..., None, :]
        return k
    d2 = _sqdist(xs, xs)
    d2.diagonal(dim1=-2, dim2=-1).zero_()
    k = _shape_fn(kind, d2).mul_(sf2[..., None, None])
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
    (``GPR_CS2S3.py:100-101``). Out of place, as :func:`kernel_matrix`,
    where an input requires a gradient (the Nystrom objective's K_nm, whose
    landmarks are training points: zero distances)."""
    e = ell[..., None, :]
    sf2 = torch.as_tensor(sf2)
    if torch.is_grad_enabled() and (x.requires_grad or ell.requires_grad or sf2.requires_grad):
        xs, ss = x / e, xstar / e
        d2 = sum(
            (xs[..., :, None, k] - ss[..., None, :, k]).square() for k in range(x.shape[-1])
        )
        k = sf2[..., None, None] * _shape_fn_autograd(kind, d2)
        return k if mask is None else k * mask.to(k.dtype)[..., :, None]
    k = _shape_fn(kind, _sqdist(x / e, xstar / e))
    k.mul_(sf2[..., None, None])
    return _masked(k, mask, cols=False)
