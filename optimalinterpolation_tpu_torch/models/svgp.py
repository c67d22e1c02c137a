"""Sparse variational GP (SVGP) of one cell (reference C14).

PyTorch counterpart of ``optimalinterpolation_tpu/models/svgp.py``. The
reference's dev branch trains GPflow's ``SVGP(Matern32, Gaussian likelihood,
50 inducing points on a per-dimension linspace, constant mean)`` with Adam
(lr 1e-3) on the ELBO for 10k minibatch steps of 100
(``dev/sparseGP_example.ipynb`` cell-5). Here, as in the JAX package, the
variational parameters are *whitened* (u = L_z v, q(v) = N(nu, S S^T)), and
every trainable (nu, S, the inducing locations Z, the five log-hypers, the
constant mean) is optimized by ``torch.optim.Adam`` with non-finite
gradients zeroed. With a Gaussian likelihood the expectations are analytic:

  E_q[log N(y_i | f_i, sn2)] = log N(y_i | mu_i, sn2) - var_i / (2 sn2)
  ELBO = (n / b) sum_batch E_q[...] - KL(q || p)
  KL   = (|nu|^2 + |S|_F^2 - M - 2 sum log |diag S|) / 2

The 10k steps are a Python loop of small launches on the card (M = 50,
b = 100), bound by launch latency. Minibatches are drawn with replacement,
weighted by the mask, from an explicit ``torch.Generator``; JAX's threefry
stream cannot be reproduced, so :func:`svgp_fit` also takes the indices
themselves. Float32 products need TF32 off (refused on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Union

import numpy as np
import torch

from optimalinterpolation_tpu_torch.ops import kernels as K
from optimalinterpolation_tpu_torch.ops import linalg as L
from optimalinterpolation_tpu_torch.ops.blocked_gp import refuse_tf32

__all__ = ["SVGPConfig", "SVGPParams", "SVGPFit", "SVGPPredict", "svgp_init", "elbo",
           "svgp_fit", "svgp_predict", "svgp_params_from_numpy"]

_LOG2PI = 1.8378770664093453


@dataclasses.dataclass(frozen=True)
class SVGPConfig:
    num_inducing: int = 50
    iterations: int = 10_000
    batch_size: int = 100
    learning_rate: float = 1e-3  # tf.optimizers.Adam() default, as the reference
    kind: K.Kernel = K.Kernel.MATERN32
    jitter: float = 1e-6
    elbo_log_every: int = 10  # the reference logs the ELBO every 10 steps


class SVGPParams(NamedTuple):
    log_hypers: torch.Tensor  # (5,) [log ell_xyz, log sf2, log sn2]
    z: torch.Tensor  # (M, 3) inducing locations
    nu: torch.Tensor  # (M,) whitened variational mean
    s: torch.Tensor  # (M, M) whitened variational sqrt (lower triangle used)
    mean: torch.Tensor  # () constant mean function


def svgp_params_from_numpy(p, device=None) -> SVGPParams:
    """:class:`SVGPParams` from the JAX package's ``SVGPParams`` (or any
    object with the same fields) as numpy arrays."""
    return SVGPParams(*(torch.tensor(np.asarray(getattr(p, f)), device=device)
                        for f in SVGPParams._fields))


def svgp_init(x: torch.Tensor, mask: torch.Tensor, num_inducing: int,
              init_log_hypers, mean: float) -> SVGPParams:
    """Inducing points on a per-dimension linspace across the valid points'
    range, the reference's Z initialization (sparseGP_example.ipynb
    cell-5); q(v) = N(0, I), the prior."""
    valid = (mask > 0)[:, None]
    lo = torch.where(valid, x, math.inf).amin(dim=0)
    hi = torch.where(valid, x, -math.inf).amax(dim=0)
    frac = torch.linspace(0.0, 1.0, num_inducing, dtype=x.dtype, device=x.device)[:, None]
    kw = dict(dtype=x.dtype, device=x.device)
    return SVGPParams(
        log_hypers=torch.as_tensor(init_log_hypers, **kw).clone(),
        z=lo[None, :] + frac * (hi - lo)[None, :],
        nu=torch.zeros(num_inducing, **kw),
        s=torch.eye(num_inducing, **kw),
        mean=torch.tensor(mean, **kw),
    )


def _marginals(params: SVGPParams, xb: torch.Tensor, kind: K.Kernel, jitter: float):
    """q(f) marginals (mu, var) at inputs xb (b, 3)."""
    refuse_tf32(xb)
    ell, sf2 = torch.exp(params.log_hypers[:3]), torch.exp(params.log_hypers[3])
    eye = torch.eye(params.z.shape[0], dtype=xb.dtype, device=xb.device)
    lz, _ = L.masked_cholesky(K.kernel_matrix(params.z, ell, sf2, kind=kind) + jitter * eye)
    a = L.tri_solve(lz, K.cross_kernel(params.z, xb, ell, sf2, kind=kind))  # (M, b)
    s_tril = params.s.tril()
    mu = params.mean + a.mT @ params.nu
    sa = s_tril.mT @ a
    var = sf2 - (a * a).sum(dim=0) + (sa * sa).sum(dim=0)
    return mu, var.clamp_min(1e-12)


def _kl(params: SVGPParams) -> torch.Tensor:
    s_tril = params.s.tril()
    diag = s_tril.diagonal().abs() + 1e-20
    m = params.nu.shape[0]
    return 0.5 * ((params.nu * params.nu).sum() + (s_tril * s_tril).sum() - m
                  - 2.0 * diag.log().sum())


def elbo(params: SVGPParams, xb: torch.Tensor, yb: torch.Tensor, wb: torch.Tensor,
         n_data, kind: K.Kernel, jitter: float) -> torch.Tensor:
    """The minibatch ELBO; ``wb`` weighs each point (0 for padding)."""
    sn2 = torch.exp(params.log_hypers[4])
    mu, var = _marginals(params, xb, kind, jitter)
    ve = -0.5 * (_LOG2PI + torch.log(sn2) + ((yb - mu) ** 2 + var) / sn2)
    b_eff = wb.sum().clamp_min(1.0)
    return (n_data / b_eff) * (wb * ve).sum() - _kl(params)


class SVGPFit(NamedTuple):
    params: SVGPParams
    elbo_log: torch.Tensor  # the ELBO before steps 0, elbo_log_every, 2 elbo_log_every, ...


def svgp_fit(params0: SVGPParams, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
             batches: Union[torch.Generator, np.ndarray, torch.Tensor],
             config: SVGPConfig = SVGPConfig()) -> SVGPFit:
    """``config.iterations`` Adam steps on -ELBO (``svgp.py:124-162``).

    ``batches``: a ``torch.Generator`` on the device of ``x``, from which
    each step's ``batch_size`` indices are drawn with replacement, weighted
    by the mask (all steps' in one draw); or an (iterations, batch_size)
    integer array of the indices themselves. Nothing comes to the host
    during the loop."""
    mval = mask.to(x.dtype)
    n_data = mval.sum()
    if isinstance(batches, torch.Generator):
        idx = torch.multinomial(mval / n_data, config.iterations * config.batch_size,
                                replacement=True, generator=batches)
        idx = idx.view(config.iterations, config.batch_size)
    else:
        idx = torch.as_tensor(np.asarray(batches), dtype=torch.int64, device=x.device)
    leaves = [p.detach().clone().requires_grad_() for p in params0]
    opt = torch.optim.Adam(leaves, lr=config.learning_rate)
    every = config.elbo_log_every
    log = torch.empty(-(-config.iterations // every), dtype=x.dtype, device=x.device)
    for t in range(config.iterations):
        i = idx[t]
        with torch.enable_grad():
            value = elbo(SVGPParams(*leaves), x[i], y[i], mval[i], n_data, config.kind,
                         config.jitter)
            opt.zero_grad()
            (-value).backward()
        for p in leaves:
            p.grad.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
        opt.step()
        if t % every == 0:
            log[t // every] = value.detach()
    return SVGPFit(SVGPParams(*(p.detach() for p in leaves)), log)


class SVGPPredict(NamedTuple):
    mean: torch.Tensor
    std: torch.Tensor


@torch.no_grad()
def svgp_predict(params: SVGPParams, xstar: torch.Tensor, kind: K.Kernel = K.Kernel.MATERN32,
                 jitter: float = 1e-6) -> SVGPPredict:
    """predict_f: the latent function's posterior marginals at xstar (q, 3)."""
    mu, var = _marginals(params, xstar, kind, jitter)
    return SVGPPredict(mean=mu, std=var.sqrt())
