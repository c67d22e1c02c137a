"""Blocked exact-GP predict for large neighborhoods (N = 2048, 4096).

PyTorch counterpart of the predict half of
``optimalinterpolation_tpu/ops/blocked_gp.py``. The covariance is held as a
block tensor (B, nb, nb, P, P) in device memory; every O(N^3) operation
(panel solves, trailing updates, the L^-1 build of a panel) is a batched
float32 matrix product left to ``torch.einsum``, and the only sequential
piece, the 128x128 diagonal factor + inverse, runs through **K1**
(``csrc/k1_factor_invert.cu``) on a CUDA tensor. Large buckets factor in
512-wide panels whose diagonal recurses once onto the 128 base case.

TF32 must stay off: at ~1e-3 relative it is the Hopper form of the TPU's
bf16 trap in Cholesky chains; :func:`_prep` refuses a CUDA run with it on.

Math and conventions are those of ``models.exact_gp.predict``:

  A = K o mm^T + diag(sf2+sn2+jitter*sf2 | 1-m),  A = L L^T
  fs = m + (L^-1 ks).(L^-1 ym),  var = sf2 - |L^-1 ks|^2
"""

from __future__ import annotations

import math

import torch

from optimalinterpolation_tpu_torch.models.exact_gp import PredictResult
from optimalinterpolation_tpu_torch.ops import _cuda
from optimalinterpolation_tpu_torch.ops import kernels as K
from optimalinterpolation_tpu_torch.ops.kernels import Kernel

__all__ = ["BLK", "PANEL", "gp_predict_blocked"]

BLK = 128
PANEL = 512
_LOG2PI = 1.8378770664093453


# ---------------------------------------------------------------------------
# 128x128 diagonal factor + inverse: K1 on the card, its plain twin on the CPU
# ---------------------------------------------------------------------------


def _factor_invert_plain(d: torch.Tensor):
    """K1's plain twin, mirroring ``_factor_invert_xla``: (B, 128, 128) ->
    (L, W = L^-1, logdet, ok), with L = W = I and logdet = 0 where the
    factor is not finite."""
    l, info = torch.linalg.cholesky_ex(d)
    diag = l.diagonal(dim1=-2, dim2=-1)
    ok = (info == 0) & torch.isfinite(diag).all(dim=-1)
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device).expand_as(d)
    l = torch.where(ok[:, None, None], l, eye)
    w = torch.linalg.solve_triangular(l, eye, upper=False)
    logdet = torch.where(ok, diag.log().sum(dim=-1), 0.0)
    return l, w, logdet, ok


def _factor_invert(d: torch.Tensor):
    """(B, P, P) symmetric blocks -> (L, W = L^-1, logdet (B,), ok (B,)).

    P = 128 is the base case: **K1** on a CUDA tensor, its plain twin on a
    CPU tensor. Larger P recurses through :func:`_factor_invert_panel`.
    ``_factor_invert.launches`` counts K1 launches.
    """
    if d.shape[-1] != BLK:
        return _factor_invert_panel(d)
    if d.device.type == "cpu":
        return _factor_invert_plain(d)
    b = d.shape[0]
    _cuda.check(d, "d", (b, BLK, BLK))
    l = torch.empty_like(d)
    w = torch.empty_like(d)
    logdet = d.new_empty(b)
    ok = torch.empty(b, dtype=torch.bool, device=d.device)
    _cuda.launch("oi_k1_factor_invert", d.device, d, l, w, logdet, ok, b)
    _factor_invert.launches += 1
    return l, w, logdet, ok


_factor_invert.launches = 0


def _factor_invert_panel(d: torch.Tensor):
    """Factor + invert a (B, P, P) panel, P a multiple of 128, by one level
    of recursion onto the 128-block machinery."""
    l4, w4, logdet, ok = _blocked_chol(_to_blocks(d, BLK))
    return _unblock(l4), _unblock(_tinv(l4, w4)), logdet, ok


# ---------------------------------------------------------------------------
# Block-tensor Cholesky + solves
# ---------------------------------------------------------------------------


def _to_blocks(a: torch.Tensor, blk: int = BLK) -> torch.Tensor:
    """(B, n, n) -> (B, nb, nb, blk, blk), a view."""
    b, n, _ = a.shape
    nb = n // blk
    return a.reshape(b, nb, blk, nb, blk).transpose(2, 3)


def _unblock(t: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_to_blocks`: (B, nb, nb, blk, blk) -> (B, n, n)."""
    b, nb, _, blk, _ = t.shape
    return t.transpose(2, 3).reshape(b, nb * blk, nb * blk)


def _build_a(log_hypers, x, mask, kind, jitter):
    """(A, sf2): A = K o mm^T + diag((sn2 + jitter*sf2) m + (1 - m)), (B, N, N)."""
    ell = torch.exp(log_hypers[:, :3])
    sf2 = torch.exp(log_hypers[:, 3])
    sn2 = torch.exp(log_hypers[:, 4])
    a = K.kernel_matrix(x, ell, sf2, kind=kind, mask=mask)
    m = mask.to(x.dtype)
    a.diagonal(dim1=-2, dim2=-1).add_((sn2[:, None] + jitter * sf2[:, None]) * m + (1.0 - m))
    return a, sf2


def _blocked_chol(ab: torch.Tensor):
    """ab: (B, nb, nb, P, P) symmetric block tensor.

    Returns (l, w, logdet, ok): l lower-block-triangular (diagonal blocks
    lower-triangular L_kk), w (B, nb, P, P) = L_kk^-1. Left-looking: column
    kb is updated once against all previous columns, nb^3/6 block products.
    ``l`` is filled in place, one block column at a time.
    """
    b, nb, blk = ab.shape[0], ab.shape[1], ab.shape[-1]
    l = torch.zeros_like(ab)
    w = ab.new_zeros((b, nb, blk, blk))
    logdet = ab.new_zeros(b)
    ok = torch.ones(b, dtype=torch.bool, device=ab.device)
    for kb in range(nb):
        dacc = ab[:, kb, kb]
        if kb > 0:
            hist = l[:, kb, :kb]  # (B, k, P, P)
            dacc = dacc - torch.einsum("bkxy,bkzy->bxz", hist, hist)
        lkk, wkk, ld, okk = _factor_invert(dacc.contiguous())
        logdet = logdet + ld
        ok = ok & okk
        w[:, kb] = wkk
        l[:, kb, kb] = lkk
        if kb + 1 < nb:
            pacc = ab[:, kb + 1 :, kb]  # (B, r, P, P)
            if kb > 0:
                pacc = pacc - torch.einsum(
                    "bikxy,bkzy->bixz", l[:, kb + 1 :, :kb], l[:, kb, :kb]
                )
            l[:, kb + 1 :, kb] = torch.einsum("bixy,bzy->bixz", pacc, wkk)
    return l, w, logdet, ok


def _fwd_solve(l, w, rhs):
    """z = L^-1 rhs with rhs (B, nb, P, R); returns the same shape."""
    nb = l.shape[1]
    z = torch.zeros_like(rhs)
    for ib in range(nb):
        acc = rhs[:, ib]
        if ib > 0:
            acc = acc - torch.einsum("bkxy,bkyr->bxr", l[:, ib, :ib], z[:, :ib])
        z[:, ib] = torch.einsum("bxy,byr->bxr", w[:, ib], acc)
    return z


def _tinv(l, w):
    """T = L^-1 as a block tensor (B, nb, nb, P, P), lower-triangular."""
    nb = l.shape[1]
    t = torch.zeros_like(l)
    for ib in range(nb):
        t[:, ib, ib] = w[:, ib]
        if ib > 0:
            acc = torch.einsum("bkxy,bkjyz->bjxz", l[:, ib, :ib], t[:, :ib, :ib])
            t[:, ib, :ib] = -torch.einsum("bxy,bjyz->bjxz", w[:, ib], acc)
    return t


def _panel_size(n: int) -> int:
    """Block width of the outer factorization: 512-wide panels for N >= 2048
    (fewer, larger block products), else 128."""
    return PANEL if (n % PANEL == 0 and n >= 2048) else BLK


def _prep(log_hypers, x, mask, kind, jitter):
    """Build A and factor it; returns (l, w, logdet, ok, sf2). A itself is
    dropped: predict needs only the factor."""
    n = x.shape[1]
    if n % BLK != 0:
        raise ValueError(f"N must be a multiple of {BLK}, got {n}")
    if x.device.type == "cuda" and (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError("TF32 matmuls are on: the blocked Cholesky needs full float32")
    a, sf2 = _build_a(log_hypers, x, mask, kind, jitter)
    l, w, logdet, ok = _blocked_chol(_to_blocks(a, _panel_size(n)))
    return l, w, logdet, ok, sf2


def _as_block_vec(v: torch.Tensor, blk: int = BLK) -> torch.Tensor:
    b, n = v.shape
    return v.reshape(b, n // blk, blk, 1)


def gp_predict_blocked(
    log_hypers, x, y, xstar, mask, mean,
    kind: Kernel = Kernel.MATERN32, jitter: float = 0.0,
) -> PredictResult:
    """Posterior (mean, std, lZ, prior_std, ok) at one test point per cell,
    blocked large-N path. y raw (uncentered); mean (B,) prior mean per cell."""
    m = mask.to(x.dtype)
    ym = (y - mean[:, None]) * m
    l, w, logdet, ok, sf2 = _prep(log_hypers, x, mask, kind, jitter)

    ell = torch.exp(log_hypers[:, :3])
    ks = K.cross_kernel(x, xstar[:, None, :], ell, sf2, kind=kind, mask=mask)[..., 0]
    p = l.shape[-1]
    rhs = torch.cat([_as_block_vec(ym, p), _as_block_vec(ks, p)], dim=3)  # (B, nb, P, 2)
    zv = _fwd_solve(l, w, rhs)
    z, v = zv[..., 0], zv[..., 1]
    quad = (z * z).sum(dim=(1, 2))
    fs = mean + (z * v).sum(dim=(1, 2))
    var = (sf2 - (v * v).sum(dim=(1, 2))).clamp_min(0.0)
    lz = -(0.5 * quad + logdet + 0.5 * m.sum(dim=1) * _LOG2PI)
    return PredictResult(
        mean=torch.where(ok, fs, math.nan),
        std=torch.where(ok, var.sqrt(), math.nan),
        lZ=torch.where(ok, lz, math.nan),
        prior_std=sf2.sqrt(),
        ok=ok,
    )
