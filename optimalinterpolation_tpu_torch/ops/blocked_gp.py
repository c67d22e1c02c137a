"""Blocked exact GP for large neighborhoods: the NLL objective with its
analytic gradient, and the predict.

PyTorch counterpart of ``optimalinterpolation_tpu/ops/blocked_gp.py``. The
covariance is held as a block tensor (B, nb, nb, P, P) in device memory;
every O(N^3) operation (panel solves, trailing updates, the L^-1 build, the
rows of A^-1) is a batched float32 matrix product left to ``torch.einsum``,
and the only sequential piece, the 128x128 diagonal factor + inverse, runs
through **K1** (``csrc/k1_factor_invert.cu``) on a CUDA tensor. Large
buckets factor in 512-wide panels whose diagonal recurses once onto the 128
base case.

TF32 must stay off: at ~1e-3 relative it is the Hopper form of the TPU's
bf16 trap in Cholesky chains; :func:`refuse_tf32` refuses a CUDA run with it
on.

Math and conventions are those of ``models.exact_gp``:

  A = K o mm^T + diag(sf2+sn2+jitter*sf2 | 1-m),  A = L L^T
  nll      = |L^-1 ym|^2 / 2 + sum log diag L + n/2 log 2pi
  d nll/dθ = 0.5 <A^-1 - alpha alpha^T, dA/dθ>
  fs = m + (L^-1 ks).(L^-1 ym),  var = sf2 - |L^-1 ks|^2
"""

from __future__ import annotations

import collections
import math

import torch

from optimalinterpolation_tpu_torch.models.exact_gp import PredictResult
from optimalinterpolation_tpu_torch.ops import _cuda
from optimalinterpolation_tpu_torch.ops import kernels as K
from optimalinterpolation_tpu_torch.ops.kernels import Kernel
from optimalinterpolation_tpu_torch.utils import counters

__all__ = [
    "BLK", "PANEL", "refuse_tf32", "gp_nll_blocked", "gp_nll_blocked_with_factors",
    "gp_grad_blocked_from_factors", "gp_nll_and_grad_blocked", "gp_predict_blocked",
]

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
    ``_factor_invert.launches`` counts K1 launches and
    ``_factor_invert.streams`` them by CUDA stream (``utils.counters``).
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
    stream = _cuda.launch("oi_k1_factor_invert", d.device, d, l, w, logdet, ok, b)
    counters.launched(_factor_invert, stream)
    return l, w, logdet, ok


_factor_invert.launches = 0
_factor_invert.streams = collections.Counter()


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


def _bwd_solve(l, w, rhs):
    """alpha = L^-T rhs with rhs (B, nb, P, R); returns the same shape."""
    nb = l.shape[1]
    out = torch.zeros_like(rhs)
    for ib in range(nb - 1, -1, -1):
        acc = rhs[:, ib]
        if ib + 1 < nb:
            acc = acc - torch.einsum("bkyx,bkyr->bxr", l[:, ib + 1 :, ib], out[:, ib + 1 :])
        out[:, ib] = torch.einsum("byx,byr->bxr", w[:, ib], acc)
    return out


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


def refuse_tf32(x: torch.Tensor) -> None:
    """Raise on a CUDA tensor while TF32 matmuls are on: the blocked
    Cholesky and everything built on it need full float32 products."""
    if x.device.type == "cuda" and (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError("TF32 matmuls are on: the blocked Cholesky needs full float32")


def _prep(log_hypers, x, mask, kind, jitter):
    """Build A and factor it; returns (l, w, logdet, ok, sf2). A itself is
    dropped: the callers need only the factor."""
    n = x.shape[1]
    if n % BLK != 0:
        raise ValueError(f"N must be a multiple of {BLK}, got {n}")
    refuse_tf32(x)
    a, sf2 = _build_a(log_hypers, x, mask, kind, jitter)
    l, w, logdet, ok = _blocked_chol(_to_blocks(a, _panel_size(n)))
    return l, w, logdet, ok, sf2


def _as_block_vec(v: torch.Tensor, blk: int = BLK) -> torch.Tensor:
    b, n = v.shape
    return v.reshape(b, n // blk, blk, 1)


# ---------------------------------------------------------------------------
# The NLL objective and its analytic gradient
# ---------------------------------------------------------------------------


def gp_nll_blocked(log_hypers, x, y, mask, kind: Kernel = Kernel.MATERN32,
                   jitter: float = 0.0) -> torch.Tensor:
    """Batched masked NLL (B,), blocked path; ``y`` centered. The value half
    of :func:`gp_nll_blocked_with_factors`."""
    return gp_nll_blocked_with_factors(log_hypers, x, y, mask, kind=kind, jitter=jitter)[0]


def gp_nll_blocked_with_factors(log_hypers, x, y, mask, kind: Kernel = Kernel.MATERN32,
                                jitter: float = 0.0):
    """Batched masked NLL (B,), ``+inf`` where the factor fails, and its
    factorization ``(l, w, z, ok)``: the blocked Cholesky, the diagonal
    blocks' inverses, z = L^-1 (y m) and the flags. A caller that needs the
    gradient at the same point passes them to
    :func:`gp_grad_blocked_from_factors` instead of factoring again (the
    optimizer's line search, whose last evaluation is at the accepted
    iterate)."""
    m = mask.to(x.dtype)
    l, w, logdet, ok, _ = _prep(log_hypers, x, mask, kind, jitter)
    z = _fwd_solve(l, w, _as_block_vec(y * m, l.shape[-1]))
    nll = 0.5 * (z * z).sum(dim=(1, 2, 3)) + logdet + 0.5 * m.sum(dim=1) * _LOG2PI
    return torch.where(ok, nll, math.inf), (l, w, z, ok)


def gp_grad_blocked_from_factors(log_hypers, x, y, mask, factors,
                                 kind: Kernel = Kernel.MATERN32, jitter: float = 0.0):
    """Analytic (B, 5) NLL gradient, NaN where the factor failed, from the
    ``factors`` of :func:`gp_nll_blocked_with_factors` at the same
    ``log_hypers``: nothing is built or factored again.

    A^-1 = T^T T with T = L^-1 block-lower-triangular, and both
    Q = A^-1 - alpha alpha^T and every dA/dθ are symmetric, so
    <Q, dA/dθ> needs only Q's lower block triangle. It is formed one
    128-block row at a time and contracted against the kernel derivatives
    at once: nothing (N, N)-sized beyond L and T is held. A 512-panel T is
    re-blocked at 128 (it is lower-triangular elementwise), which keeps the
    row's (B, i+1, 128, 128, 3) displacements small."""
    b, n, _ = x.shape
    nb = n // BLK
    m = mask.to(x.dtype)
    l, w, z, ok = factors
    sf2 = torch.exp(log_hypers[:, 3])
    sn2 = torch.exp(log_hypers[:, 4])
    alpha = _bwd_solve(l, w, z).reshape(b, nb, BLK)
    t = _tinv(l, w)
    if l.shape[-1] != BLK:
        t = _to_blocks(_unblock(t), BLK)
    qxb = (x / torch.exp(log_hypers[:, None, :3])).reshape(b, nb, BLK, 3)
    mb = m.reshape(b, nb, BLK)
    g_ell = x.new_zeros((b, 3))
    gs = x.new_zeros(b)
    qdiag = x.new_zeros(b)
    sf2_4 = sf2[:, None, None, None]
    for i in range(nb):
        # block row i of A^-1 left of the diagonal: (B, i+1, 128, 128),
        # axes (batch, column block j, row point, column point)
        row = torch.einsum("bkxy,bkjxz->bjyz", t[:, i:, i], t[:, i:, : i + 1])
        qrow = row - alpha[:, i][:, None, :, None] * alpha[:, : i + 1][:, :, None, :]
        # off-diagonal blocks twice (symmetry), the diagonal block once
        qrow[:, :i] *= 2.0
        qm = qrow * (mb[:, i][:, None, :, None] * mb[:, : i + 1][:, :, None, :])
        dd = qxb[:, i][:, None, :, None, :] - qxb[:, : i + 1][:, :, None, :, :]
        dd2 = dd * dd
        d2 = dd2.sum(dim=-1)
        qmw = qm * (sf2_4 * K._dlogell_weight(kind, d2))
        g_ell = g_ell + torch.einsum("bjxz,bjxzd->bd", qmw, dd2)
        gs = gs + (qm * (sf2_4 * K._shape_fn(kind, d2))).sum(dim=(1, 2, 3))
        qdiag = qdiag + (qrow[:, i].diagonal(dim1=-2, dim2=-1) * mb[:, i]).sum(dim=-1)
    gs = gs + jitter * sf2 * qdiag
    grad = 0.5 * torch.cat([g_ell, gs[:, None], (sn2 * qdiag)[:, None]], dim=1)
    return torch.where(ok[:, None], grad, math.nan)


def gp_nll_and_grad_blocked(log_hypers, x, y, mask, kind: Kernel = Kernel.MATERN32,
                            jitter: float = 0.0):
    """Batched masked NLL (B,) and analytic (B, 5) gradient, blocked path:
    one factorization serves both."""
    nll, factors = gp_nll_blocked_with_factors(log_hypers, x, y, mask, kind=kind, jitter=jitter)
    return nll, gp_grad_blocked_from_factors(log_hypers, x, y, mask, factors, kind=kind,
                                             jitter=jitter)


# ---------------------------------------------------------------------------
# Predict
# ---------------------------------------------------------------------------


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
