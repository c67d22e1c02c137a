"""Batched exact-GP predict over buckets of cells.

PyTorch counterpart of ``optimalinterpolation_tpu/models/exact_gp_batch.py``:
per-cell hyperparameters and prior means, one test point per cell, the
predict of the reference's pass 2 (``GPR3D(opt=False)``,
``GPR_CS2S3.py:169-186``), which is the quicklook production path.
"""

from __future__ import annotations

from optimalinterpolation_tpu_torch.models.exact_gp import PredictResult
from optimalinterpolation_tpu_torch.ops import blocked_gp, fused_gp
from optimalinterpolation_tpu_torch.ops.kernels import Kernel

__all__ = ["predict_batch"]


def predict_batch(
    log_hypers,  # (B, 5)
    x,  # (B, N, 3)
    y,  # (B, N) raw observations (uncentered)
    xstar,  # (B, 3)
    mask,  # (B, N)
    mean,  # (B,) per-cell prior mean
    kind: Kernel = Kernel.MATERN32,
    jitter: float = 0.0,
) -> PredictResult:
    """Batched posterior predict, routed on N alone: the fused K2 path for
    N in [128, 1024], the blocked K1 path for larger multiples of 128, and
    the plain batched predict (K2's twin) otherwise. The device only decides
    kernel versus twin, inside each wrapper, so a CPU run walks the same
    routes as the card."""
    n = x.shape[1]
    if fused_gp.supported(n):
        return fused_gp.gp_predict(log_hypers, x, y, xstar, mask, mean, kind=kind, jitter=jitter)
    if n % blocked_gp.BLK == 0:
        return blocked_gp.gp_predict_blocked(
            log_hypers, x, y, xstar, mask, mean, kind=kind, jitter=jitter
        )
    return fused_gp.gp_predict_plain(log_hypers, x, y, xstar, mask, mean, kind=kind, jitter=jitter)
