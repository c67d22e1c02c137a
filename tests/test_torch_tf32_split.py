"""The arithmetic of the 3xTF32 tile products of K2 and K3, on the CPU.

``csrc/gp_common.cuh`` runs every 128x128 tile product on the tensor cores
with each operand split into hi = tf32(x) and lo = tf32(x - hi) (rounded as
``cvt.rna.tf32.f32`` rounds: to nearest, ties away from zero) and
acc += a_lo b_hi + a_hi b_lo, then += a_hi b_hi. Here the rounding is
emulated through the bits of float32 tensors and pinned on hand-picked
values; then K3's value + gradient is transcribed in float32 with every tile
product (the Cholesky's panel and trailing update, L^-T's and Q's products)
through the emulated split, every other operation as in
``fused_gp.gp_nll_and_grad_plain``, and held against the float64 twin at
``chip_smoke.py``'s gates: value within 1e-5 relative, gradient within
max(1e-3 |g|_inf, 4 x the float32 twin's deviation). One product in plain
TF32 misses the value gate, which shows that the gate can fail.
"""

import numpy as np
import pytest
import torch

from optimalinterpolation_tpu_torch.ops import fused_gp
from optimalinterpolation_tpu_torch.ops import kernels as K
from optimalinterpolation_tpu_torch.ops import linalg as L
from optimalinterpolation_tpu_torch.ops.kernels import Kernel

BLK = 128


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: add half a unit to the magnitude bits, then truncate."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _f32(bits: int) -> float:
    return float(np.array([bits], np.uint32).view(np.float32)[0])


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),  # 1.0
    (0x3F801000, 0x3F802000),  # 1 + 2^-11, a tie: away from zero (even would keep 1.0)
    (0xBF801000, 0xBF802000),  # the negative tie
    (0x3F800FFF, 0x3F800000),  # just below the tie: down
    (0x3F801001, 0x3F802000),  # just above: up
    (0x3F803000, 0x3F804000),  # 1 + 3 2^-11, a tie with an odd last bit
    (0x3FFFF000, 0x40000000),  # carries into the exponent: 2.0
    (0x7F7FFFFF, 0x7F800000),  # the largest float rounds up to inf
    (0x7F800000, 0x7F800000),  # inf stays inf
    (0x80000000, 0x80000000),  # -0.0
    (0x00000FFF, 0x00000000),  # a subnormal below the tie: +0
])
def test_tf32_rounding_pinned(bits, want):
    x = torch.tensor([_f32(bits)], dtype=torch.float32)
    assert int(tf32(x).view(torch.int32)[0]) & 0xFFFFFFFF == want


def test_split_carries_float32():
    """hi + lo carries x to ~2^-22 relative; hi alone to 2^-11."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=100_000).astype(np.float32))
    hi = tf32(x)
    lo = tf32(x - hi)
    assert ((hi.double() - x.double()).abs() / x.double().abs()).max() <= 2.0 ** -11
    assert ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max() <= 2.0 ** -22


def _product_3x(a, b, acc):
    """acc + a b^T as the tile engine computes it: lo terms first, then
    hi hi; each term's sum in float32 (products of TF32 values are exact)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    for p, q in ((al, bh), (ah, bl), (ah, bh)):
        acc = acc + (p.double() @ q.double().mT).float()
    return acc


def _product_1x(a, b, acc):
    """acc + a b^T in one plain TF32 product (ruled out)."""
    return acc + (tf32(a).double() @ tf32(b).double().mT).float()


def _blk(m, i, j):
    return m[:, i * BLK:(i + 1) * BLK, j * BLK:(j + 1) * BLK]


def _nll_and_grad_tiled(log_hypers, x, y, mask, kind, jitter, product):
    """K3's value + gradient in float32: the blocked Cholesky, U = L^-T and
    Q's lower block triangle with every 128x128 tile product through
    ``product``; the diagonal 128-blocks, the solves and the five sums as in
    ``gp_nll_and_grad_plain``."""
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
    nb = x.shape[1] // BLK
    eye = torch.eye(BLK, dtype=x.dtype).expand(x.shape[0], BLK, BLK)
    ok = torch.ones(x.shape[0], dtype=torch.bool)
    lmat = torch.zeros_like(a)
    w = []
    for kb in range(nb):
        lkk, info = torch.linalg.cholesky_ex(_blk(a, kb, kb))
        ok &= info == 0
        w.append(torch.linalg.solve_triangular(lkk, eye, upper=False))
        _blk(lmat, kb, kb)[:] = lkk
        for ib in range(kb + 1, nb):
            _blk(lmat, ib, kb)[:] = product(_blk(a, ib, kb), w[kb], torch.zeros_like(lkk))
        for ib in range(kb + 1, nb):
            for jb in range(kb + 1, ib + 1):
                _blk(a, ib, jb)[:] = product(-_blk(lmat, ib, kb), _blk(lmat, jb, kb),
                                             _blk(a, ib, jb))
    logdet = lmat.diagonal(dim1=-2, dim2=-1).log().sum(dim=-1)
    t = L.tri_solve(lmat, torch.eye(x.shape[1], dtype=x.dtype).expand_as(lmat))
    z = (t @ (y * m)[:, :, None])[:, :, 0]
    alpha = (t.mT @ z[:, :, None])[:, :, 0]
    nll = 0.5 * (z * z).sum(dim=-1) + logdet + 0.5 * m.sum(dim=-1) * fused_gp._LOG2PI
    # U = L^-T, upper block triangle: U_jj = W_j^T, U_ji = -(sum U_jk L_ik^T) W_i^T
    u = torch.zeros_like(a)
    for jb in range(nb):
        _blk(u, jb, jb)[:] = w[jb].mT
        for ib in range(jb + 1, nb):
            s = torch.zeros_like(eye)
            for kb in range(jb, ib):
                s = product(_blk(u, jb, kb), _blk(lmat, ib, kb), s)
            _blk(u, jb, ib)[:] = product(-s, w[ib], torch.zeros_like(s))
    q = torch.zeros_like(a)
    for jb in range(nb):
        for ib in range(jb, nb):
            s = torch.zeros_like(eye)
            for kb in range(ib, nb):
                s = product(_blk(u, ib, kb), _blk(u, jb, kb), s)
            _blk(q, ib, jb)[:] = s
            _blk(q, jb, ib)[:] = s.mT
    qm = (q - alpha[:, :, None] * alpha[:, None, :]) * mm
    qw = qm * (sf2[:, None, None] * K._dlogell_weight(kind, d2))
    qdiag = qm.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    grad = 0.5 * torch.stack(
        [(qw * dq2[d]).sum(dim=(1, 2)) for d in range(3)]
        + [(qm * kmat).sum(dim=(1, 2)) + jitter * sf2 * qdiag, sn2 * qdiag],
        dim=1,
    )
    return torch.where(ok, nll, torch.inf), torch.where(ok[:, None], grad, torch.nan)


def _k3_problem(rng, b, n):
    """``chip_smoke.py::_k3_problem``'s inputs (masked rows, differing hypers,
    row 2 all padding), without its NaN row."""
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.0, 0.05, (b, n))
    mask = (rng.random((b, n)) < 0.85).astype(np.float64)
    mask[2] = 0.0
    h = np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]) + rng.normal(0.0, 0.2, (b, 5))
    return h, x, y, mask


def _day_cells(rng, b, n):
    """Cells at the synthetic day's density: n points in a 300 km disc over
    a 9-day window, Matern-3/2 at the slice's hypers (sn2 / sf2 = 0.17)."""
    r = 3e5 * np.sqrt(rng.random((b, n)))
    phi = rng.uniform(0.0, 2.0 * np.pi, (b, n))
    t = rng.uniform(-4.0, 4.0, (b, n))
    x = np.stack([r * np.cos(phi), r * np.sin(phi), t], axis=-1)
    y = rng.normal(0.0, 0.05, (b, n))
    mask = np.ones((b, n))
    h = np.tile(np.log([2e5, 2e5, 2.0, 0.03, 0.005]), (b, 1))
    return h, x, y, mask


def _errors(inputs, product):
    """(value rel. error, gradient max error, gradient gate) of the tiled
    transcription against the float64 twin."""
    kw = dict(kind=Kernel.MATERN32, jitter=1e-6)
    t32 = [torch.tensor(a, dtype=torch.float32) for a in inputs]
    ref_v, ref_g = fused_gp.gp_nll_and_grad_plain(*[a.double() for a in t32], **kw)
    twin_v, twin_g = fused_gp.gp_nll_and_grad_plain(*t32, **kw)
    got_v, got_g = _nll_and_grad_tiled(*t32, product=product, **kw)
    assert bool(torch.isfinite(ref_v).all())
    dv = ((got_v.double() - ref_v).abs() / ref_v.abs().clamp_min(1.0)).max().item()
    dg = (got_g.double() - ref_g).abs().max().item()
    tol = max(1e-3 * ref_g.abs().max().item(), 4.0 * (twin_g.double() - ref_g).abs().max().item())
    return dv, dg, tol


CASES = {
    "k3_problem_n256": lambda: _k3_problem(np.random.default_rng(2), 4, 256),
    "k3_problem_n512": lambda: _k3_problem(np.random.default_rng(3), 3, 512),
    "day_density_n512": lambda: _day_cells(np.random.default_rng(4), 2, 512),
}


@pytest.mark.parametrize("case", list(CASES))
def test_3xtf32_products_meet_the_gates(case):
    dv, dg, tol = _errors(CASES[case](), _product_3x)
    assert dv <= 1e-5
    assert dg <= tol


def test_one_tf32_product_misses_the_value_gate():
    dv, _, _ = _errors(CASES["day_density_n512"](), _product_1x)
    assert dv > 1e-5
