"""Fused per-cell posterior predict: **K2** (``csrc/k2_predict.cu``).

PyTorch counterpart of the predict half of
``optimalinterpolation_tpu/ops/pallas_gp.py`` (``gp_predict``, body
``_predict_kernel``). One CUDA block per cell builds the masked covariance
from x, factors it with a blocked Cholesky whose 128x128 diagonal blocks go
through the same routine as K1, runs one forward sweep for
z = L^-1 (y - mean) m and v = L^-1 k*, and writes mean, std, lZ, prior_std
and ok. The kernel allocates nothing: this wrapper hands it a (B, N, N) and
a (B, N, 128) float32 scratch.

On a CPU tensor :func:`gp_predict` runs its plain twin
:func:`gp_predict_plain` (``models.exact_gp.predict`` at one test point per
cell); on any other device it launches K2 or raises.
"""

from __future__ import annotations

import torch

from optimalinterpolation_tpu_torch.models import exact_gp
from optimalinterpolation_tpu_torch.models.exact_gp import PredictResult
from optimalinterpolation_tpu_torch.ops import _cuda
from optimalinterpolation_tpu_torch.ops.kernels import Kernel

__all__ = ["BLK", "supported", "gp_predict", "gp_predict_plain"]

BLK = 128
_KIND_ID = {Kernel.MATERN12: 0, Kernel.MATERN32: 1, Kernel.MATERN52: 2, Kernel.SE: 3}


def supported(n: int) -> bool:
    """K2 handles N in [128, 1024], multiples of 128 (``pallas_gp.py:477``)."""
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
    """Fused posterior predict. ``gp_predict.launches`` counts K2 launches."""
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
    _cuda.launch(
        "oi_k2_predict", x.device, log_hypers, x, y, xstar, mask, mean,
        a_scr, w_scr, out, b, n, _KIND_ID[Kernel(kind)], float(jitter),
    )
    gp_predict.launches += 1
    return PredictResult(out[:, 0], out[:, 1], out[:, 2], out[:, 3], out[:, 4] > 0.5)


gp_predict.launches = 0
