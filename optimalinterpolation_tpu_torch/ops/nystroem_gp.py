"""Batched Nystrom NLL objective for large-neighborhood hyperparameter fits.

PyTorch counterpart of ``optimalinterpolation_tpu/ops/nystroem_gp.py``: the
marginal likelihood of the rank-M Nystrom approximation (the reference's own
large-n answer, ``GP_example.ipynb`` cell-1 ``Nystroem`` with
``SMLII(approx=True)``), O(N M^2) a cell instead of O(N^3). Only the fit
uses it; prediction stays exact.

  landmarks = the first M neighbor slots (the pipeline shuffles each row's
              valid points first, so they are a uniform subsample; masked
              slots pad to identity and drop out of every term exactly)
  Amm       = Kmm o mm^T + (mm_jitter sf2 | 1-m) I,   Amm = Lm Lm^T
  Phi       = Knm Lm^-T                               (N, M)
  C         = D I_M + Phi^T Phi,  D = sn2 + jitter sf2,  C = Lc Lc^T
  nll       = [|ym|^2 - |Lc^-1 Phi^T ym|^2] / (2 D)
              + sum log diag Lc + (n_valid - M)/2 log D + n_valid/2 log 2pi

Both (M, M) factorizations go through :func:`chol_inv`, whose forward is
``ops.blocked_gp._factor_invert``: **K1** on every 128x128 diagonal block on
a CUDA tensor (4 launches at M = 512), the plain twin on a CPU tensor; never
a library Cholesky on the card. Its backward is the Cholesky pullback
written with the explicit inverse W = L^-1: matrix products only. Every other
product is a float32 ``torch.matmul`` (the JAX package's einsums), with TF32
refused. The gradient comes from autograd.
"""

from __future__ import annotations

import math

import torch

from optimalinterpolation_tpu_torch.ops import blocked_gp
from optimalinterpolation_tpu_torch.ops import kernels as K
from optimalinterpolation_tpu_torch.ops.kernels import Kernel

__all__ = ["chol_inv", "chol_inv_plain", "gp_nll_nystroem", "gp_nll_and_grad_nystroem"]

_LOG2PI = 1.8378770664093453
# Jitter on the landmark Gram matrix, relative to sf2: Kmm has no noise
# diagonal, and a smooth kernel's Gram over clustered points is numerically
# rank-deficient in float32 (eps M sf2 ~ 3e-5 sf2 at M = 512). The
# approximation error it adds is far below the rank-M truncation's.
_MM_JITTER = 1e-4


class _CholInv(torch.autograd.Function):
    """(B, M, M) SPD -> (L, W = L^-1, logdet = sum log diag L, ok).

    Backward: the W and logdet cotangents are folded into L's,

      dW = -W dL W             =>  L_bar += -W^T W_bar W^T
      dlogdet = tr(diag(L)^-1 dL) =>  L_bar += diag(logdet_bar / diag L)

    then A_bar = sym(W^T Phi(L^T L_bar) W), Phi = lower triangle with half
    the diagonal (``nystroem_gp.py:103-119``)."""

    @staticmethod
    def forward(ctx, a):
        l, w, logdet, ok = blocked_gp._factor_invert(a.contiguous())
        ctx.save_for_backward(l, w)
        ctx.mark_non_differentiable(ok)
        return l, w, logdet, ok

    @staticmethod
    def backward(ctx, lb, wb, ldb, _okb):
        l, w = ctx.saved_tensors
        lb_eff = lb - w.mT @ wb @ w.mT
        lb_eff = lb_eff + torch.diag_embed(ldb[:, None] / l.diagonal(dim1=1, dim2=2))
        s = l.mT @ lb_eff.tril()
        phi_s = s.tril() - 0.5 * torch.diag_embed(s.diagonal(dim1=1, dim2=2))
        g = w.mT @ phi_s @ w
        return 0.5 * (g + g.mT)


def chol_inv(a: torch.Tensor):
    """(B, M, M) SPD, M a multiple of 128 -> (L, W = L^-1, logdet, ok),
    differentiable in ``a``; K1 under it on a CUDA tensor."""
    return _CholInv.apply(a)


def chol_inv_plain(a: torch.Tensor):
    """:func:`chol_inv`'s plain twin on any device and dtype: one library
    Cholesky of the whole matrix (``blocked_gp._factor_invert_plain``),
    differentiated by autograd. The objectives take it only where a caller
    passes it as ``factor``: float64 references on the card, where K1
    (float32 only) cannot run."""
    return blocked_gp._factor_invert_plain(a)


def gp_nll_nystroem(
    log_hypers: torch.Tensor,  # (B, 5)
    x: torch.Tensor,  # (B, N, 3)
    y: torch.Tensor,  # (B, N) centered
    mask: torch.Tensor,  # (B, N)
    m_inducing: int,
    kind: Kernel = Kernel.MATERN32,
    jitter: float = 0.0,
    factor=chol_inv,
) -> torch.Tensor:
    """Batched Nystrom-approximate masked NLL, (B,); ``+inf`` where either
    factor fails. The landmarks are each row's first ``m_inducing`` slots;
    the noise diagonal is ``sn2 + jitter * sf2`` as on the exact paths, so
    the objective tends to the exact NLL as M -> n_valid. ``factor`` makes
    both (M, M) factorizations: :func:`chol_inv` or :func:`chol_inv_plain`."""
    mi = m_inducing
    if mi % blocked_gp.BLK != 0:
        raise ValueError(f"m_inducing must be a multiple of {blocked_gp.BLK}, got {mi}")
    blocked_gp.refuse_tf32(x)
    ell = torch.exp(log_hypers[:, :3])
    sf2 = torch.exp(log_hypers[:, 3])
    sn2 = torch.exp(log_hypers[:, 4])
    m = mask.to(x.dtype)
    ym = y * m
    n_valid = m.sum(dim=1)
    d_noise = sn2 + jitter * sf2

    xm, mm = x[:, :mi], m[:, :mi]
    kmm = K.kernel_matrix(xm, ell, sf2, kind=kind, mask=mm)
    amm = kmm + torch.diag_embed((_MM_JITTER * sf2)[:, None] * mm + (1.0 - mm))
    _, wm, _, ok1 = factor(amm)

    # rows masked by m, padded landmark columns zeroed
    knm = K.cross_kernel(x, xm, ell, sf2, kind=kind, mask=m) * mm[:, None, :]
    phi = knm @ wm.mT  # Knm Lm^-T, (B, N, M)
    eye = torch.eye(mi, dtype=x.dtype, device=x.device)
    core = phi.mT @ phi + d_noise[:, None, None] * eye
    _, wc, logdet_c, ok2 = factor(core)  # logdet_c = log det(core) / 2

    zc = (wc @ (phi.mT @ ym[:, :, None]))[:, :, 0]  # Lc^-1 Phi^T ym
    quad = ((ym * ym).sum(dim=1) - (zc * zc).sum(dim=1)) / d_noise
    # det lemma: log det(K~ + D I_n) = log det(core) + (n - M) log D. A padded
    # landmark slot adds exactly D to core's diagonal (its Phi column is 0),
    # so the static-M form is exact for rows with fewer valid points.
    nll = 0.5 * quad + logdet_c + 0.5 * (n_valid - mi) * torch.log(d_noise) \
        + 0.5 * n_valid * _LOG2PI
    return torch.where(ok1 & ok2, nll, math.inf)


def gp_nll_and_grad_nystroem(
    log_hypers, x, y, mask, m_inducing: int,
    kind: Kernel = Kernel.MATERN32, jitter: float = 0.0, factor=chol_inv,
):
    """Batched Nystrom NLL (B,) and its (B, 5) gradient by autograd. Rows
    are independent, so the gradient of the sum of the finite rows is each
    row's own; a row whose value is not finite gets a NaN gradient row."""
    with torch.enable_grad():
        h = log_hypers.detach().requires_grad_()
        nll = gp_nll_nystroem(h, x, y, mask, m_inducing, kind=kind, jitter=jitter,
                              factor=factor)
        finite = torch.isfinite(nll)
        (grad,) = torch.autograd.grad(torch.where(finite, nll, 0.0).sum(), h)
    return nll.detach(), torch.where(finite[:, None], grad, math.nan)
