"""Nystrom low-rank approximation of one cell's GP (reference C13).

PyTorch counterpart of ``optimalinterpolation_tpu/models/nystroem.py``: the
notebook ``Nystroem`` function (``GP_example.ipynb`` cell-1; demo M = 925 in
cell-5), a rank-M approximation K ~ Knm Kmm^-1 Kmn over landmarks given as
indices of valid points, factored through Cholesky features:

  Lm = chol(Kmm + jitter sf2 I),   Phi = Knm Lm^-T           (n, M)
  (K~ + sn2 I)^-1 v = (v - Phi (sn2 I_M + Phi^T Phi)^-1 Phi^T v) / sn2
  log det(K~ + sn2 I) = log det(sn2 I_M + Phi^T Phi) + (n - M) log sn2

``ref_det_convention=True`` drops the ``(n - M) log sn2`` term, as the
reference's approximate NLL does. This is the ``cell`` command's model, for
one cell and any M (the demo's 925 is no multiple of 128): plain torch, with
a library Cholesky of Kmm, formed in float64 (see ``_phi``; ``cholesky_ex``,
so a failed factor gives an ``inf`` NLL and NaN predictions, as JAX's NaN
factor does, and never raises). The day's rank-M objective is ``ops/nystroem_gp.py``, another
function on K1. Float32 products need TF32 off (refused on the card).

The Woodbury step differs from the JAX package's in its arithmetic, not its
value. There, the core sn2 I_M + Phi^T Phi is Cholesky-factored and
v^T (K~ + sn2 I)^-1 v = (|v|^2 - |Lc^-1 Phi^T v|^2) / sn2 cancels two large
numbers: on the demo cell (M = 925 of 1,024 points, the 25 km synthetic
day) the float32 std came out anywhere within +-0.016 m of the float64 one
(0.016 m) as the hypers moved by 1e-4. Here every quadratic form is a
product of least-squares residuals: with B = [Phi; sqrt(sn2) I_M] = Q R, the
residual of min_w |[v; 0] - B w| is r(v) = [v; 0] - Q Q^T [v; 0], its first
n rows are sn2 (K~ + sn2 I)^-1 v, and u^T (K~ + sn2 I)^-1 v = r(u) . r(v) /
sn2, since r(u) is orthogonal to the columns of Q. The same cell's float32
std then comes within 2.1e-5 m of float64 and its mean within 5.1e-6 m
(float32 on the CPU, twelve such perturbations). R^T R is the core, so its
log-determinant is 2 sum log |R_ii|.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from optimalinterpolation_tpu_torch.ops import kernels as K
from optimalinterpolation_tpu_torch.ops import linalg as L
from optimalinterpolation_tpu_torch.ops.blocked_gp import refuse_tf32

__all__ = ["nystroem_nll", "nystroem_predict", "NystroemPredict"]

_LOG2PI = 1.8378770664093453


def _phi(x, landmark_idx, ell, sf2, kind, mask, jitter):
    """Cholesky Nystrom features Phi = Knm Lm^-T (masked rows zeroed), in
    the dtype of ``x``, and whether Lm factored. Kmm, Knm and the factor are
    formed in float64 whatever the dtype: rounded to float32, Kmm's entries
    carry errors of ~6e-8 sf2 each, a symmetric perturbation of norm
    ~2 sqrt(M) 6e-8 sf2 that outweighs the jitter (1e-6 sf2 in the ``cell``
    command) once M is in the hundreds, so the float32 Gram of smooth-kernel
    landmarks is indefinite and its factor fails (the demo cell's float32
    fit ended at such hypers, seen on the card). Phi itself is well scaled."""
    dt = x.dtype
    x, ell, sf2 = x.double(), ell.double(), sf2.double()
    xm = x[landmark_idx]
    eye = torch.eye(landmark_idx.shape[0], dtype=x.dtype, device=x.device)
    lm, ok = L.masked_cholesky(K.kernel_matrix(xm, ell, sf2, kind=kind) + jitter * sf2 * eye)
    knm = K.cross_kernel(x, xm, ell, sf2, kind=kind, mask=mask)  # (n_pad, M)
    return L.tri_solve(lm, knm.mT).mT.to(dt), ok


def _woodbury(phi, sn2):
    """(resid, half_logdet_m, ok): ``resid(v)``, the (n + M, k) residual
    r(v) of the module docstring for (n, k) right-hand sides, and half the
    log-determinant of the (M, M) core sn2 I_M + Phi^T Phi, both from the QR
    factorization of [Phi; sqrt(sn2) I_M]."""
    n, m = phi.shape
    eye = torch.eye(m, dtype=phi.dtype, device=phi.device)
    q, r = torch.linalg.qr(torch.cat([phi, sn2.sqrt() * eye]))
    diag = r.diagonal().abs()

    def resid(v):
        return torch.cat([v, v.new_zeros((m, v.shape[1]))]) - q @ (q[:n].mT @ v)

    return resid, diag.log().sum(), torch.isfinite(diag).all() & (diag > 0).all()


def nystroem_nll(
    log_hypers: torch.Tensor,  # (5,)
    x: torch.Tensor,  # (n_pad, 3)
    y: torch.Tensor,  # (n_pad,) centered targets
    landmark_idx: torch.Tensor,  # (M,) int indices into x (valid points only)
    mask: torch.Tensor,  # (n_pad,)
    kind: K.Kernel = K.Kernel.MATERN32,
    jitter: float = 1e-8,
    ref_det_convention: bool = False,
) -> torch.Tensor:
    """Approximate negative log marginal likelihood, O(n M^2); ``+inf``
    where a factor fails. Differentiable in ``log_hypers`` (autograd)."""
    refuse_tf32(x)
    ell, sf2, sn2 = torch.exp(log_hypers[:3]), torch.exp(log_hypers[3]), torch.exp(log_hypers[4])
    mval = mask.to(x.dtype)
    ym = (y * mval)[:, None]
    n = mval.sum()
    m = landmark_idx.shape[0]
    phi, ok1 = _phi(x, landmark_idx, ell, sf2, kind, mask, jitter)
    resid, half_logdet_m, ok2 = _woodbury(phi, sn2)
    quad = 0.5 * resid(ym).square().sum() / sn2
    # det lemma: log det(K~ + sn2 I_n) = log det(core) - M log sn2 + n log sn2
    half_logdet = half_logdet_m - 0.5 * m * torch.log(sn2)
    if not ref_det_convention:
        half_logdet = half_logdet + 0.5 * n * torch.log(sn2)
    nlz = quad + half_logdet + 0.5 * n * _LOG2PI
    return torch.where(ok1 & ok2, nlz, math.inf)


class NystroemPredict(NamedTuple):
    mean: torch.Tensor  # (q,)
    std: torch.Tensor  # (q,)
    ok: torch.Tensor  # () both factors succeeded


def nystroem_predict(
    log_hypers: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,  # raw (uncentered) observations
    xstar: torch.Tensor,  # (q, 3)
    landmark_idx: torch.Tensor,
    mask: torch.Tensor,
    mean,
    kind: K.Kernel = K.Kernel.MATERN32,
    jitter: float = 1e-8,
) -> NystroemPredict:
    """Posterior mean/std with the Nystrom-approximated inverse, the
    reference's ``GPR(approx=True)``: fs = mean + K*^T Ki y,
    sfs = sqrt(max(sf2 - diag(K*^T Ki K*), 0)); NaN where a factor fails."""
    refuse_tf32(x)
    ell, sf2, sn2 = torch.exp(log_hypers[:3]), torch.exp(log_hypers[3]), torch.exp(log_hypers[4])
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    ym = ((y - mean) * mask.to(x.dtype))[:, None]
    phi, ok1 = _phi(x, landmark_idx, ell, sf2, kind, mask, jitter)
    resid, _, ok2 = _woodbury(phi, sn2)
    ok = ok1 & ok2
    rk = resid(K.cross_kernel(x, xstar, ell, sf2, kind=kind, mask=mask))  # (n, q)
    fs = mean + (rk * resid(ym)).sum(dim=0) / sn2
    err = rk.square().sum(dim=0) / sn2
    std = (sf2 - err).clamp_min(0.0).sqrt()
    return NystroemPredict(mean=torch.where(ok, fs, math.nan), std=torch.where(ok, std, math.nan),
                           ok=ok)
