"""The 32-wide panel order of the 128x128 factor + inverse, float64 on the CPU.

``csrc/factor_invert.cuh`` (the routine of K1 and of every diagonal step of
K2 and K3) runs only on the card. This file transcribes its order of
operations in float64 torch and holds it against the JAX package's
``blocked_gp._factor_invert_xla`` and the port's ``_factor_invert_plain``:

  per panel p of 32 columns,
  1. the diagonal 32x32 block by an unblocked right-looking elimination
     whose row operations, applied to I, give W_pp = L_pp^-1 (the warp's
     pivot steps; pivots clamped at 1e-37, NaN kept, ok = every pivot > 0);
  2. the panel L_ip = A_ip W_pp^T (i > p) and W_pj = W_pp R_pj (j < p);
  3. the trailing update A_ij -= L_ip L_jp^T and R_ij -= L_ip W_pj, with
     R_ip = -L_ip W_pp: R_ij = -sum_{j <= k < i} L_ik W_kj, so that
     W_ij = -W_ii sum_{k=j}^{i-1} L_ik W_kj.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalinterpolation_tpu.ops import blocked_gp as JB
from optimalinterpolation_tpu_torch.ops import blocked_gp as TB


BLK, PW = 128, 32
NP = BLK // PW


def _diag_32(a: torch.Tensor):
    """Step 1 on a (B, 32, 32) block: (L_pp, W_pp, logdet, ok). Row j of W
    is used unscaled by the rows below it and scaled once at the end."""
    c = a.clone()
    v = torch.eye(PW, dtype=a.dtype).repeat(a.shape[0], 1, 1)
    rs = a.new_zeros(a.shape[0], PW)
    logdet = a.new_zeros(a.shape[0])
    ok = torch.ones(a.shape[0], dtype=torch.bool)
    for j in range(PW):
        piv = c[:, j, j]
        ok &= piv > 0
        piv_s = torch.where(piv < 1e-37, torch.full_like(piv, 1e-37), piv)  # NaN stays NaN
        logdet += 0.5 * torch.log(piv_s)
        rs[:, j] = 1.0 / torch.sqrt(piv_s)
        l = c[:, j:, j] * rs[:, j, None]  # column j of L
        f = l[:, 1:] * rs[:, j, None]  # rows i > j: A_ij / pivot
        c[:, j + 1:, j + 1:] -= f[:, :, None] * c[:, None, j + 1:, j]
        v[:, j + 1:, :j + 1] -= f[:, :, None] * v[:, None, j, :j + 1]
        c[:, j:, j] = l
    return c.tril(), (v * rs[:, :, None]).tril(), logdet, ok


def _factor_invert_panels(d: torch.Tensor):
    """(B, 128, 128) -> (L, W, logdet, ok) in the kernel's panel order."""
    a = d.clone()
    l = torch.zeros_like(d)
    w = torch.zeros_like(d)
    r = {}
    logdet = d.new_zeros(d.shape[0])
    ok = torch.ones(d.shape[0], dtype=torch.bool)

    def blk(i):
        return slice(i * PW, (i + 1) * PW)

    for p in range(NP):
        sp, below = blk(p), slice((p + 1) * PW, BLK)
        lpp, wpp, ld, okp = _diag_32(a[:, sp, sp])
        logdet += ld
        ok &= okp
        l[:, sp, sp] = lpp
        w[:, sp, sp] = wpp
        l[:, below, sp] = a[:, below, sp] @ wpp.mT
        for j in range(p):
            w[:, sp, blk(j)] = wpp @ r[p, j]
        a[:, below, below] -= l[:, below, sp] @ l[:, below, sp].mT
        for i in range(p + 1, NP):
            for j in range(p + 1):
                prod = l[:, blk(i), sp] @ w[:, sp, blk(j)]
                r[i, j] = -prod if j == p else r[i, j] - prod
    return l, w, logdet, ok


def _spd(rng, b):
    g = rng.standard_normal((b, BLK, BLK))
    return g @ g.transpose(0, 2, 1) / BLK + 0.5 * np.eye(BLK)


def _matern32(rng, b, n, noise):
    """Matern-3/2 covariances (sf2 = 1) of n points at the synthetic season's
    scales (ell 2e5 m, coordinates over +-3e5 m), noise = sn2/sf2, jitter 1e-6."""
    x = rng.uniform(-3e5, 3e5, (b, n, 2)) / 2e5
    r = np.sqrt(3.0 * ((x[:, :, None] - x[:, None]) ** 2).sum(-1))
    return (1.0 + r) * np.exp(-r) + (noise + 1e-6) * np.eye(n)


def _blocks(kind: str):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "spd":
        return _spd(rng, 4)
    if kind == "matern":
        return _matern32(rng, 4, BLK, 0.17)
    if kind == "schur":  # the second diagonal step of a 256-point cell
        a = _matern32(rng, 4, 2 * BLK, 0.17)
        return a[:, BLK:, BLK:] - a[:, BLK:, :BLK] @ np.linalg.solve(
            a[:, :BLK, :BLK], a[:, :BLK, BLK:])
    if kind == "padded":  # mask-0 rows and columns are identity
        d = _spd(rng, 3)
        m = (rng.random((3, BLK)) < 0.7).astype(np.float64)
        m[1] = 0.0  # an all-padding block: exactly I
        return d * m[:, :, None] * m[:, None] + np.eye(BLK) * (1.0 - m)[:, None]
    d = _spd(rng, 3)  # "nonpd": bad pivots in panel 0 and 3, in 3 alone, none
    d[0, 5, 5] = -1.0
    d[0, 100, 100] = -50.0
    d[1, 100, 100] = -50.0
    return d


@pytest.mark.parametrize("kind", ["spd", "matern", "schur", "padded", "nonpd"])
def test_panel_order_matches_references(kind):
    d = _blocks(kind)
    l, w, logdet, ok = _factor_invert_panels(torch.from_numpy(d))
    lj, wj, ldj, okj = JB._factor_invert_xla(jnp.asarray(d))
    lt, wt, ldt, okt = TB._factor_invert_plain(torch.from_numpy(d))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(ok.numpy(), okt.numpy())
    good = ok.numpy()
    if kind == "nonpd":
        assert good.tolist() == [False, False, True]
    else:
        assert good.all()
    # relative to the largest entry: the Matern blocks' W reaches ~10
    for got, ref_j, ref_t in ((l, lj, lt), (w, wj, wt)):
        got, ref_j = got.numpy()[good], np.asarray(ref_j)[good]
        scale = np.abs(ref_j).max()
        np.testing.assert_allclose(got, ref_j, atol=1e-12 * scale, rtol=0)
        np.testing.assert_allclose(got, ref_t.numpy()[good], atol=1e-12 * scale, rtol=0)
    np.testing.assert_allclose(logdet.numpy()[good], np.asarray(ldj)[good], rtol=1e-12, atol=0)
    np.testing.assert_allclose(logdet.numpy()[good], ldt.numpy()[good], rtol=1e-12, atol=0)
    assert bool((w.triu(1) == 0).all())
    if kind == "padded":  # identity rows give L = W = I and add exactly 0
        assert torch.equal(l[1], torch.eye(BLK, dtype=l.dtype))
        assert torch.equal(w[1], torch.eye(BLK, dtype=w.dtype)) and logdet[1] == 0


def test_nan_block_is_not_ok():
    d = _blocks("spd")
    d[1, 40, 40] = np.nan
    _, _, logdet, ok = _factor_invert_panels(torch.from_numpy(d))
    assert ok.tolist() == [True, False, True, True] and torch.isnan(logdet[1])
