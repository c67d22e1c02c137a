"""Exact Gaussian-process regression on masked/padded neighborhoods.

PyTorch counterpart of ``optimalinterpolation_tpu/models/exact_gp.py``: the
reference's ``SMLII`` value (``GPR_CS2S3.py:107-141``) and the predict block
of its ``GPR3D`` (``:173-184``). It is the semantic source of truth of the
port: the blocked path, K2 and K3 are held against it, and the gradient of
the objective comes from autograd here. Hyperparameters live in log space as
``[log ell_x, log ell_y, log ell_t, log sf2, log sn2]``
(``GPR_CS2S3.py:120-122``). Every function takes any leading batch shape.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from optimalinterpolation_tpu_torch.ops import kernels as K
from optimalinterpolation_tpu_torch.ops import linalg as L

__all__ = ["HYPER_INIT_LOG", "neg_log_marginal_likelihood", "PredictResult", "predict"]

_LOG2PI = 1.8378770664093453


def HYPER_INIT_LOG(grid_res_m: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """The reference's x0 initial hyperparameter guess
    (``GP_example.ipynb`` cell-3): [log res, log res, log 1, log 1, log 0.1]."""
    lr = math.log(grid_res_m)
    return torch.tensor([lr, lr, 0.0, 0.0, math.log(0.1)], dtype=dtype, device=device)


class PredictResult(NamedTuple):
    """Per-cell outputs, mirroring ``GPR3D``'s return tuple
    (``GPR_CS2S3.py:184``) plus the prior std and validity."""

    mean: torch.Tensor  # fs: posterior mean at the test point(s)
    std: torch.Tensor  # sfs: posterior std (1 sigma)
    lZ: torch.Tensor  # log marginal likelihood of the training set
    prior_std: torch.Tensor  # sqrt(K**)
    ok: torch.Tensor  # Cholesky success flag


def _unpack(log_hypers: torch.Tensor):
    return (
        torch.exp(log_hypers[..., :3]),
        torch.exp(log_hypers[..., 3]),
        torch.exp(log_hypers[..., 4]),
    )


def neg_log_marginal_likelihood(
    log_hypers: torch.Tensor,  # (..., 5)
    x: torch.Tensor,  # (..., n, 3)
    y: torch.Tensor,  # (..., n) centered observations
    mask: torch.Tensor,  # (..., n)
    kind: K.Kernel = K.Kernel.MATERN32,
    jitter: float = 0.0,
) -> torch.Tensor:
    """Masked negative log marginal likelihood (the reference's ``SMLII``
    value, ``GPR_CS2S3.py:126-128``):

      nlZ = y^T A^-1 y / 2 + sum log diag L + n_valid log(2 pi) / 2

    with ``n_valid = sum(mask)``, so padding changes nothing, and
    ``jitter * sf2`` on the valid diagonal. ``y`` must already be centered
    (the reference passes ``y - mX``). ``+inf`` where the Cholesky fails
    (the ``LinAlgError -> inf`` path, ``:139-140``); its gradient there is
    not finite or zero, and the optimizer rejects such a step on the value.
    """
    ell, sf2, sn2 = _unpack(log_hypers)
    m = mask.to(x.dtype)
    ym = y * m
    a = L.masked_psd_matrix(
        K.kernel_matrix(x, ell, sf2, kind=kind, mask=mask), sn2, mask, jitter * sf2
    )
    chol, ok = L.masked_cholesky(a)
    alpha = L.chol_solve(chol, ym[..., None])[..., 0]
    logdet = chol.diagonal(dim1=-2, dim2=-1).log().sum(dim=-1)
    nlz = 0.5 * (ym * alpha).sum(dim=-1) + logdet + 0.5 * m.sum(dim=-1) * _LOG2PI
    return torch.where(ok, nlz, math.inf)


def predict(
    log_hypers: torch.Tensor,  # (..., 5)
    x: torch.Tensor,  # (..., n, 3)
    y: torch.Tensor,  # (..., n) raw (uncentered) observations
    xstar: torch.Tensor,  # (..., q, 3) test inputs
    mask: torch.Tensor,  # (..., n)
    mean,  # (...) scalar prior mean per problem
    kind: K.Kernel = K.Kernel.MATERN32,
    jitter: float = 0.0,
) -> PredictResult:
    """Posterior mean/std at ``xstar`` plus training lZ:

      fs  = mean + Kxsx^T alpha,  alpha = A^-1 (y - mean) m
      sfs = sqrt(max(sf2 - |v|^2, 0)),  v = L^-1 Kxsx
      lZ  = -(y-m)^T alpha / 2 - sum log diag L - n_valid log(2 pi) / 2

    with ``jitter * sf2`` added to the valid diagonal, and NaN mean, std
    and lZ where the factorization fails.
    """
    ell, sf2, sn2 = _unpack(log_hypers)
    m = mask.to(x.dtype)
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    ym = (y - mean[..., None]) * m
    a = L.masked_psd_matrix(
        K.kernel_matrix(x, ell, sf2, kind=kind, mask=mask), sn2, mask, jitter * sf2
    )
    chol, ok = L.masked_cholesky(a)
    alpha = L.chol_solve(chol, ym[..., None])  # (..., n, 1)

    ks = K.cross_kernel(x, xstar, ell, sf2, kind=kind, mask=mask)  # (..., n, q)
    v = L.tri_solve(chol, ks)
    fs = mean[..., None] + (ks * alpha).sum(dim=-2)  # (..., q)
    var = sf2[..., None] - (v * v).sum(dim=-2)
    std = var.clamp_min(0.0).sqrt()

    n_valid = m.sum(dim=-1)
    logdet = chol.diagonal(dim1=-2, dim2=-1).log().sum(dim=-1)
    lz = -0.5 * (ym * alpha[..., 0]).sum(dim=-1) - logdet - 0.5 * n_valid * _LOG2PI

    nan = torch.full_like(fs, math.nan)
    okq = ok[..., None]
    return PredictResult(
        mean=torch.where(okq, fs, nan),
        std=torch.where(okq, std, nan),
        lZ=torch.where(ok, lz, math.nan),
        prior_std=sf2.sqrt()[..., None].expand_as(fs),
        ok=ok,
    )
