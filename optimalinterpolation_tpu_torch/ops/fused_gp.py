"""Fused per-cell kernels: **K2**, the posterior predict
(``csrc/k2_predict.cu``), and **K3**, the marginal likelihood with its
analytic gradient (``csrc/k3_nll_grad.cu``).

PyTorch counterpart of ``optimalinterpolation_tpu/ops/pallas_gp.py``
(``gp_predict``, body ``_predict_kernel``; ``gp_nll`` / ``gp_nll_and_grad``,
body ``_nll_kernel``). For the predict, one CUDA block per cell builds the masked covariance
from x, factors it with a blocked Cholesky whose 128x128 diagonal blocks go
through the same routine as K1 and whose tile products run in 3xTF32 on the
tensor cores, runs one forward sweep for
z = L^-1 (y - mean) m and v = L^-1 k*, and writes mean, std, lZ, prior_std
and ok. The kernel allocates nothing: this wrapper hands it a (B, N, N) and
a (B, N, 128) float32 scratch.

K3 works the same way on the objective of the hyperparameter fit: masked
covariance, blocked Cholesky, z = L^-1 (y m), and in the gradient variant
alpha = L^-T z, L^-T itself, and Q = A^-1 - alpha alpha^T folded against the
kernel derivatives (a second (B, N, N) scratch; the value variant has none).
The gradient is an output of the kernel, not a backward pass.

On a CPU tensor each wrapper runs its plain twin (:func:`gp_predict_plain`,
:func:`gp_nll_plain`, :func:`gp_nll_and_grad_plain`); on any other device it
launches its kernel or raises.
"""

from __future__ import annotations

import collections
import math

import torch

from optimalinterpolation_tpu_torch.models import exact_gp
from optimalinterpolation_tpu_torch.models.exact_gp import PredictResult
from optimalinterpolation_tpu_torch.ops import _cuda
from optimalinterpolation_tpu_torch.ops import kernels as K
from optimalinterpolation_tpu_torch.ops import linalg as L
from optimalinterpolation_tpu_torch.ops.kernels import Kernel
from optimalinterpolation_tpu_torch.utils import counters

__all__ = [
    "BLK", "supported", "gp_predict", "gp_predict_plain",
    "gp_nll", "gp_nll_plain", "gp_nll_and_grad", "gp_nll_and_grad_plain",
]

BLK = 128
_LOG2PI = 1.8378770664093453
_KIND_ID = {Kernel.MATERN12: 0, Kernel.MATERN32: 1, Kernel.MATERN52: 2, Kernel.SE: 3}


def supported(n: int) -> bool:
    """K2 and K3 handle N in [128, 1024], multiples of 128
    (``pallas_gp.py:477``)."""
    return n % BLK == 0 and BLK <= n <= 1024


def gp_predict_plain(
    log_hypers, x, y, xstar, mask, mean,
    kind: Kernel = Kernel.MATERN32, jitter: float = 0.0,
) -> PredictResult:
    """K2's plain twin: the batched exact predict at one test point per cell
    (``xstar`` (B, 3)); any N, any device, any float dtype."""
    r = exact_gp.predict(
        log_hypers, x, y, xstar[:, None, :], mask, mean, kind=kind, jitter=jitter
    )
    return PredictResult(r.mean[:, 0], r.std[:, 0], r.lZ, r.prior_std[:, 0], r.ok)


def gp_predict(
    log_hypers: torch.Tensor,  # (B, 5)
    x: torch.Tensor,  # (B, N, 3)
    y: torch.Tensor,  # (B, N) raw observations
    xstar: torch.Tensor,  # (B, 3)
    mask: torch.Tensor,  # (B, N)
    mean: torch.Tensor,  # (B,) per-cell prior mean
    kind: Kernel = Kernel.MATERN32,
    jitter: float = 0.0,
) -> PredictResult:
    """Fused posterior predict. ``gp_predict.launches`` counts K2 launches
    and ``gp_predict.streams`` them by CUDA stream (``utils.counters``)."""
    if x.device.type == "cpu":
        return gp_predict_plain(log_hypers, x, y, xstar, mask, mean, kind=kind, jitter=jitter)
    b, n, _ = x.shape
    if not supported(n):
        raise ValueError(f"K2 needs N in [128, 1024], a multiple of 128; got {n}")
    for t, name, shape in (
        (log_hypers, "log_hypers", (b, 5)), (x, "x", (b, n, 3)), (y, "y", (b, n)),
        (xstar, "xstar", (b, 3)), (mask, "mask", (b, n)), (mean, "mean", (b,)),
    ):
        _cuda.check(t, name, shape)
    a_scr = x.new_empty((b, n, n))
    w_scr = x.new_empty((b, n, BLK))
    out = x.new_empty((b, 5))
    stream = _cuda.launch(
        "oi_k2_predict", x.device, log_hypers, x, y, xstar, mask, mean,
        a_scr, w_scr, out, b, n, _KIND_ID[Kernel(kind)], float(jitter),
    )
    counters.launched(gp_predict, stream)
    return PredictResult(out[:, 0], out[:, 1], out[:, 2], out[:, 3], out[:, 4] > 0.5)


gp_predict.launches = 0
gp_predict.streams = collections.Counter()


def gp_nll_plain(
    log_hypers, x, y, mask, kind: Kernel = Kernel.MATERN32, jitter: float = 0.0,
) -> torch.Tensor:
    """K3's plain twin, value only: the batched masked NLL (B,) of
    ``models.exact_gp``; any N, any device, any float dtype."""
    return exact_gp.neg_log_marginal_likelihood(
        log_hypers, x, y, mask, kind=kind, jitter=jitter
    )


def gp_nll_and_grad_plain(
    log_hypers, x, y, mask, kind: Kernel = Kernel.MATERN32, jitter: float = 0.0,
):
    """K3's plain twin with the gradient: (nll (B,), grad (B, 5)).

    The gradient is K3's analytic form in dense tensors, not autograd: with
    T = L^-1, alpha = T^T T (y m) and Q = T^T T - alpha alpha^T,

      d nll / d log ell_d = 1/2 <Q, sf2 w(d2) dq_d^2 o mm^T>
      d nll / d log sf2   = 1/2 <Q, K o mm^T + jitter sf2 diag(m)>
      d nll / d log sn2   = 1/2 sn2 sum_i Q_ii m_i

    (``pallas_gp.py:20-27``). ``+inf`` and NaN where the Cholesky fails."""
    kind = Kernel(kind)
    ell = torch.exp(log_hypers[:, :3])
    sf2 = torch.exp(log_hypers[:, 3])
    sn2 = torch.exp(log_hypers[:, 4])
    m = mask.to(x.dtype)
    mm = m[:, :, None] * m[:, None, :]
    xs = x / ell[:, None, :]
    dq2 = [(xs[:, :, None, d] - xs[:, None, :, d]).square() for d in range(3)]
    d2 = dq2[0] + dq2[1] + dq2[2]
    kmat = sf2[:, None, None] * K._shape_fn(kind, d2) * mm
    a = L.masked_psd_matrix(kmat.clone(), sn2, mask, jitter * sf2)
    chol, ok = L.masked_cholesky(a)
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device).expand_as(chol)
    t = L.tri_solve(chol, eye)  # T = L^-1
    z = (t @ (y * m)[:, :, None])[:, :, 0]
    alpha = (t.mT @ z[:, :, None])[:, :, 0]
    logdet = chol.diagonal(dim1=-2, dim2=-1).log().sum(dim=-1)
    nll = 0.5 * (z * z).sum(dim=-1) + logdet + 0.5 * m.sum(dim=-1) * _LOG2PI
    qm = (t.mT @ t - alpha[:, :, None] * alpha[:, None, :]) * mm
    qw = qm * (sf2[:, None, None] * K._dlogell_weight(kind, d2))
    qdiag = qm.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    grad = 0.5 * torch.stack(
        [(qw * dq2[d]).sum(dim=(1, 2)) for d in range(3)]
        + [(qm * kmat).sum(dim=(1, 2)) + jitter * sf2 * qdiag, sn2 * qdiag],
        dim=1,
    )
    return (
        torch.where(ok, nll, math.inf),
        torch.where(ok[:, None], grad, math.nan),
    )


def _launch_k3(log_hypers, x, y, mask, kind, jitter, with_grad: bool):
    b, n, _ = x.shape
    if not supported(n):
        raise ValueError(f"K3 needs N in [128, 1024], a multiple of 128; got {n}")
    for t, name, shape in (
        (log_hypers, "log_hypers", (b, 5)), (x, "x", (b, n, 3)), (y, "y", (b, n)),
        (mask, "mask", (b, n)),
    ):
        _cuda.check(t, name, shape)
    a_scr = x.new_empty((b, n, n))
    w_scr = x.new_empty((b, n, BLK))
    u_scr = x.new_empty((b, n, n)) if with_grad else None
    nll = x.new_empty((b,))
    grad = x.new_empty((b, 5)) if with_grad else None
    stream = _cuda.launch(
        "oi_k3_nll", x.device, log_hypers, x, y, mask, a_scr, u_scr, w_scr, nll, grad,
        b, n, _KIND_ID[Kernel(kind)], float(jitter), int(with_grad),
    )
    return nll, grad, stream


def gp_nll(
    log_hypers: torch.Tensor,  # (B, 5)
    x: torch.Tensor,  # (B, N, 3)
    y: torch.Tensor,  # (B, N) centered observations
    mask: torch.Tensor,  # (B, N)
    kind: Kernel = Kernel.MATERN32,
    jitter: float = 0.0,
) -> torch.Tensor:
    """Batched masked GP NLL (B,), value only (the line search's
    evaluations). ``gp_nll.launches`` counts K3 value launches,
    ``gp_nll.rows[B]`` those of B rows and ``gp_nll.streams`` them by CUDA
    stream."""
    if x.device.type == "cpu":
        return gp_nll_plain(log_hypers, x, y, mask, kind=kind, jitter=jitter)
    nll, _, stream = _launch_k3(log_hypers, x, y, mask, kind, jitter, with_grad=False)
    counters.launched(gp_nll, stream, rows=x.shape[0])
    return nll


gp_nll.launches = 0
gp_nll.rows = collections.Counter()
gp_nll.streams = collections.Counter()


def gp_nll_and_grad(
    log_hypers: torch.Tensor,  # (B, 5)
    x: torch.Tensor,  # (B, N, 3)
    y: torch.Tensor,  # (B, N) centered observations
    mask: torch.Tensor,  # (B, N)
    kind: Kernel = Kernel.MATERN32,
    jitter: float = 0.0,
):
    """Batched masked GP NLL (B,) and its analytic (B, 5) gradient.
    ``gp_nll_and_grad.launches`` counts K3 gradient launches and
    ``gp_nll_and_grad.streams`` them by CUDA stream."""
    if x.device.type == "cpu":
        return gp_nll_and_grad_plain(log_hypers, x, y, mask, kind=kind, jitter=jitter)
    nll, grad, stream = _launch_k3(log_hypers, x, y, mask, kind, jitter, with_grad=True)
    counters.launched(gp_nll_and_grad, stream)
    return nll, grad


gp_nll_and_grad.launches = 0
gp_nll_and_grad.streams = collections.Counter()
