"""Plain exact GP of the reference (``GPR_CS2S3.py:78-191``), in PyTorch,
independent of the port: the anisotropic Matern-3/2 covariance over
(x, y, t), its negative log marginal likelihood with the analytic gradient,
the posterior mean and standard deviation at the cell, a batched L-BFGS,
and the gap that says how far a fit stopped short of its optimum.

Hyperparameters are ``[log ell_x, log ell_y, log ell_t, log sf2, log sn2]``.
Cells of one call are padded to one length with a mask; a padded slot is
the identity row of ``A``, so it changes no value. ``jitter * sf2`` is added
to the valid diagonal, as the reference's production settings do.

It runs in whatever dtype it is handed: float64 is the reference; float32
with ``torch.backends.cuda.matmul.allow_tf32 = True`` is the control (the
same arithmetic one precision step below the configuration's float32 with
TF32 off). The products ``A^-1 = T^T T`` and the solves against it are
matrix products, so TF32 reaches them.
"""

from __future__ import annotations

import math

import torch

LOG2PI = math.log(2.0 * math.pi)


def _scaled_sq(x: torch.Tensor, ell: torch.Tensor):
    """Per-dimension squared differences of the inputs over the
    length-scales, (B, n, n) each, and their sum."""
    xs = x / ell[:, None, :]
    dq2 = [(xs[:, :, None, d] - xs[:, None, :, d]) ** 2 for d in range(3)]
    return dq2, dq2[0] + dq2[1] + dq2[2]


def covariance(lh: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, jitter: float):
    """``A = K o mm^T + (sn2 + jitter sf2) diag(m) + diag(1 - m)``, with K's
    pieces for the gradient: (A, K o mm^T, dq2, r)."""
    ell, sf2, sn2 = lh[:, :3].exp(), lh[:, 3].exp(), lh[:, 4].exp()
    m = mask.to(x.dtype)
    mm = m[:, :, None] * m[:, None, :]
    dq2, d2 = _scaled_sq(x, ell)
    r = torch.sqrt(3.0 * d2)
    k = sf2[:, None, None] * (1.0 + r) * torch.exp(-r) * mm
    diag = (sn2 + jitter * sf2)[:, None] * m + (1.0 - m)
    a = k + torch.diag_embed(diag)
    return a, k, dq2, r


def _inverse(a: torch.Tensor):
    """(A^-1, log det A, ok) by Cholesky: T = L^-1, A^-1 = T^T T."""
    chol, info = torch.linalg.cholesky_ex(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand_as(a)
    t = torch.linalg.solve_triangular(chol, eye, upper=False)
    logdet = 2.0 * chol.diagonal(dim1=-2, dim2=-1).log().sum(-1)
    ok = (info == 0) & torch.isfinite(logdet)
    return t.mT @ t, logdet, ok


def nll_and_grad(lh, x, y, mask, jitter: float):
    """NLL (B,) and its gradient (B, 5) of centred observations ``y``.
    +inf / NaN where the factorization fails."""
    a, k, dq2, r = covariance(lh, x, mask, jitter)
    m = mask.to(x.dtype)
    ym = y * m
    ainv, logdet, ok = _inverse(a)
    alpha = (ainv @ ym[:, :, None])[:, :, 0]
    nll = 0.5 * (ym * alpha).sum(-1) + 0.5 * logdet + 0.5 * m.sum(-1) * LOG2PI
    mm = m[:, :, None] * m[:, None, :]
    q = (ainv - alpha[:, :, None] * alpha[:, None, :]) * mm
    sf2, sn2 = lh[:, 3].exp(), lh[:, 4].exp()
    w = 3.0 * sf2[:, None, None] * torch.exp(-r) * mm  # d k / d log ell_d = w dq_d^2
    qdiag = q.diagonal(dim1=-2, dim2=-1).sum(-1)
    grad = 0.5 * torch.stack(
        [(q * w * dq2[d]).sum((1, 2)) for d in range(3)]
        + [(q * k).sum((1, 2)) + jitter * sf2 * qdiag, sn2 * qdiag], dim=1)
    return (torch.where(ok, nll, math.inf), torch.where(ok[:, None], grad, math.nan))


def predict(lh, x, z, xstar, mask, prior: float, jitter: float):
    """Posterior mean and standard deviation (B,) at ``xstar`` (B, 3):
    ``prior + k*^T A^-1 (z - prior)`` and ``sqrt(max(sf2 - k*^T A^-1 k*, 0))``."""
    a, _, _, _ = covariance(lh, x, mask, jitter)
    m = mask.to(x.dtype)
    ainv, _, ok = _inverse(a)
    ell, sf2 = lh[:, :3].exp(), lh[:, 3].exp()
    d2 = (((x - xstar[:, None, :]) / ell[:, None, :]) ** 2).sum(-1)
    r = torch.sqrt(3.0 * d2)
    ks = sf2[:, None] * (1.0 + r) * torch.exp(-r) * m
    resid = (z - prior) * m
    mean = prior + (ks[:, None, :] @ (ainv @ resid[:, :, None]))[:, 0, 0]
    var = sf2 - (ks[:, None, :] @ (ainv @ ks[:, :, None]))[:, 0, 0]
    std = var.clamp_min(0.0).sqrt()
    nan = torch.full_like(mean, math.nan)
    return torch.where(ok, mean, nan), torch.where(ok, std, nan)


def lbfgs(lh0, x, y, mask, jitter: float, iters: int = 60, memory: int = 6,
          gtol: float = 1e-7):
    """A batched L-BFGS from ``lh0``, each row on its own: the two-loop
    direction (steepest descent of 0.1 in log space where it has no pair
    yet or no descent), a backtracking line search to the Armijo condition,
    a row stopping where its step fails or its gradient falls below
    ``gtol``. Returns (log-hypers, NLL)."""
    lh = lh0.clone()
    f, g = nll_and_grad(lh, x, y, mask, jitter)
    live = torch.isfinite(f) & torch.isfinite(g).all(1)
    pairs = []
    for _ in range(iters):
        q = torch.where(live[:, None], g, 0.0)
        alphas = []
        for s, yv, rho in reversed(pairs):
            a = rho * (s * q).sum(1)
            q = q - a[:, None] * yv
            alphas.append(a)
        gmax = g.abs().amax(1).clamp_min(1e-30)
        gamma = 0.1 / gmax
        if pairs:
            s, yv, rho = pairs[-1]
            yy = (yv * yv).sum(1)
            gamma = torch.where(rho > 0, 1.0 / (rho * yy.clamp_min(1e-300)), gamma)
        r = gamma[:, None] * q
        for (s, yv, rho), a in zip(pairs, reversed(alphas)):
            b = rho * (yv * r).sum(1)
            r = r + s * (a - b)[:, None]
        d = -r
        slope = (d * g).sum(1)
        steep = -(0.1 / gmax)[:, None] * g
        bad = ~(slope < 0) | ~torch.isfinite(d).all(1)
        d = torch.where(bad[:, None], steep, d)
        slope = torch.where(bad, (steep * g).sum(1), slope)
        t = torch.ones_like(f)
        for _ in range(30):
            f1, g1 = nll_and_grad(lh + t[:, None] * d, x, y, mask, jitter)
            ok = f1 <= f + 1e-4 * t * slope
            if bool((ok | ~live).all()):
                break
            t = torch.where(ok, t, 0.5 * t)
        accept = ok & live & torch.isfinite(g1).all(1)
        s = torch.where(accept[:, None], t[:, None] * d, 0.0)
        yv = torch.where(accept[:, None], g1 - g, 0.0)
        sy = (s * yv).sum(1)
        pairs = (pairs + [(s, yv, torch.where(sy > 0, 1.0 / sy.clamp_min(1e-300), 0.0))])[-memory:]
        lh = lh + s
        f = torch.where(accept, f1, f)
        g = torch.where(accept[:, None], g1, g)
        live = accept & (g.abs().amax(1) > gtol)
        if not bool(live.any()):
            break
    return lh, f


def fit_gap(lh, x, y, mask, jitter: float) -> torch.Tensor:
    """The NLL at ``lh`` minus the NLL a float64 L-BFGS reaches from there:
    what the fit that stopped at ``lh`` left on the table, in nats (+inf
    where the NLL at ``lh`` is not finite)."""
    f0, _ = nll_and_grad(lh, x, y, mask, jitter)
    _, f1 = lbfgs(lh, x, y, mask, jitter)
    return torch.where(torch.isfinite(f0), f0 - torch.minimum(f0, f1), math.inf)
