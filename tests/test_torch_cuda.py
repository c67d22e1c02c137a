"""K1, K2 and K3 on the card against their plain twins, the blocked and
Nystrom objectives built on K1 against float64, and a wave of days against
the same days one by one (marker ``cuda``).

These tests need an NVIDIA card and ``nvcc``; without them they skip. They
import no JAX, so on the card they run without the suite's conftest:

  python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances are float32 ones: the kernels run in float32, the twins in
float64 on the same (float32-rounded) inputs.
"""

import numpy as np
import pytest
import torch

from optimalinterpolation_tpu_torch.ops import blocked_gp, fused_gp, nystroem_gp
from optimalinterpolation_tpu_torch.ops.kernels import Kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spd_blocks(rng, b):
    g = rng.standard_normal((b, 128, 128))
    d = g @ g.transpose(0, 2, 1) / 128 + 0.5 * np.eye(128)
    d[-1] -= 3.0 * np.eye(128)  # not positive definite
    return 0.5 * (d + d.transpose(0, 2, 1))


def test_k1_matches_twin(card):
    d = torch.tensor(_spd_blocks(np.random.default_rng(0), 9), dtype=torch.float32, device=card)
    before = blocked_gp._factor_invert.launches
    l, w, logdet, ok = blocked_gp._factor_invert(d)
    assert blocked_gp._factor_invert.launches == before + 1
    lt, wt, logdet_t, ok_t = blocked_gp._factor_invert_plain(d.double())
    assert torch.equal(ok, ok_t) and not bool(ok[-1]) and bool(ok[:-1].all())
    good = ok
    torch.testing.assert_close(l.double()[good], lt[good], atol=1e-5, rtol=0)
    torch.testing.assert_close(w.double()[good], wt[good], atol=1e-4, rtol=0)
    torch.testing.assert_close(logdet.double()[good], logdet_t[good], rtol=1e-5, atol=0)
    assert bool((l.triu(1) == 0).all())


def _k1_padded(rng):
    d = _spd_blocks(rng, 2)[:1]
    m = (rng.random(128) < 0.7).astype(np.float64)
    return d * m[:, None] * m[None] + np.diag(1.0 - m)


def _k1_bad(rng, pivots):
    d = _spd_blocks(rng, 2)[:1]
    for i, v in pivots:
        d[0, i, i] = v
    return d


# block -> expected ok; panels of the factor are 32 columns wide
_K1_EDGE = {
    "identity": (lambda rng: np.eye(128)[None], True),
    "padded": (_k1_padded, True),
    "bad_panels_0_and_3": (lambda rng: _k1_bad(rng, [(5, -1.0), (100, -50.0)]), False),
    "bad_panel_3": (lambda rng: _k1_bad(rng, [(100, -50.0)]), False),
    "nan": (lambda rng: _k1_bad(rng, [(40, np.nan)]), False),
}


@pytest.mark.parametrize("case", list(_K1_EDGE))
def test_k1_edge_blocks(card, case):
    make, want_ok = _K1_EDGE[case]
    d = torch.tensor(make(np.random.default_rng(5)), dtype=torch.float32, device=card)
    l, w, logdet, ok = blocked_gp._factor_invert(d)
    assert bool(ok[0]) is want_ok
    assert bool(blocked_gp._factor_invert_plain(d.double())[3][0]) is want_ok
    if case == "identity":  # L = W = I and logdet 0, exactly
        eye = torch.eye(128, device=card)
        assert torch.equal(l[0], eye) and torch.equal(w[0], eye) and logdet[0] == 0
    if case == "padded":  # identity rows and columns stay exactly identity
        pad = d[0].diagonal() == 1.0
        assert bool((l[0][pad][:, pad] == torch.eye(int(pad.sum()), device=card)).all())
        lt, wt, ldt, _ = blocked_gp._factor_invert_plain(d.double())
        torch.testing.assert_close(l.double(), lt, atol=1e-5, rtol=0)
        torch.testing.assert_close(logdet.double(), ldt, rtol=1e-5, atol=0)
    if case == "nan":
        assert torch.isnan(logdet[0])


def _matern_blocks(rng, b, noise):
    """Matern-3/2 blocks (sf2 = 1) at the synthetic season's scales, noise =
    sn2 / sf2, jitter 1e-6; with noise 0 the condition number reaches ~1e5."""
    x = rng.uniform(-3e5, 3e5, (b, 128, 2)) / 2e5
    r = np.sqrt(3.0 * ((x[:, :, None] - x[:, None]) ** 2).sum(-1))
    return (1.0 + r) * np.exp(-r) + (noise + 1e-6) * np.eye(128)


@pytest.mark.parametrize("noise", [0.17, 0.0])
def test_k1_matern_blocks_against_float64(card, noise):
    """|L L^T - D|, |W L - I| and logdet within the larger of the random-SPD
    gates and 4 x the float32 twin's own deviation; two launches bit-equal."""
    d = torch.tensor(_matern_blocks(np.random.default_rng(6), 8, noise),
                     dtype=torch.float32, device=card)
    got = blocked_gp._factor_invert(d)
    assert all(torch.equal(a, b) for a, b in zip(got, blocked_gp._factor_invert(d)))
    ref_ld = blocked_gp._factor_invert_plain(d.double())[2]
    twin = blocked_gp._factor_invert_plain(d)
    assert bool(got[3].all()) and bool(twin[3].all())
    eye = torch.eye(128, dtype=torch.float64, device=card)

    def errors(l, w, logdet):
        l64 = l.double()
        return ((l64 @ l64.mT - d.double()).abs().max().item() / d.abs().max().item(),
                (w.double() @ l64 - eye).abs().max().item(),
                ((logdet.double() - ref_ld).abs() / ref_ld.abs().clamp_min(1.0)).max().item())

    for e, e32, gate in zip(errors(*got[:3]), errors(*twin[:3]), (1e-5, 1e-4, 1e-4)):
        assert e <= max(gate, 4.0 * e32)


@pytest.mark.parametrize("kind", list(Kernel))
@pytest.mark.parametrize("n", [128, 256, 384])  # 128 / 256: OI_BUCKET_128 / OI_BUCKET_256
def test_k2_matches_twin(card, kind, n):
    rng = np.random.default_rng(n)
    b = 6
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.1, 0.05, (b, n))
    mask = (rng.random((b, n)) < 0.85).astype(np.float64)
    h = np.tile(np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]), (b, 1))
    h[1] += 0.3
    h[-1] = np.nan
    xs = rng.uniform(-1e5, 1e5, (b, 3)) * np.asarray([1, 1, 0]) + np.asarray([0.0, 0.0, 4.0])
    mean = np.full((b,), 0.15)
    args = [torch.tensor(a, dtype=torch.float32, device=card) for a in (h, x, y, xs, mask, mean)]
    before = fused_gp.gp_predict.launches
    r = fused_gp.gp_predict(*args, kind=kind, jitter=1e-6)
    assert fused_gp.gp_predict.launches == before + 1
    ref = fused_gp.gp_predict_plain(*[a.double() for a in args], kind=kind, jitter=1e-6)
    assert torch.equal(r.ok, ref.ok) and not bool(r.ok[-1]) and bool(r.ok[:-1].all())
    ok = ref.ok
    torch.testing.assert_close(r.mean.double()[ok], ref.mean[ok], atol=1e-4, rtol=0)
    torch.testing.assert_close(r.std.double()[ok], ref.std[ok], atol=1e-4, rtol=0)
    torch.testing.assert_close(r.lZ.double()[ok], ref.lZ[ok], rtol=1e-4, atol=0)
    torch.testing.assert_close(r.prior_std.double()[ok], ref.prior_std[ok], rtol=1e-6, atol=0)
    assert torch.isnan(r.mean[-1]) and torch.isnan(r.std[-1]) and torch.isnan(r.lZ[-1])


def test_blocked_predict_on_card_uses_k1(card):
    rng = np.random.default_rng(3)
    b, n = 2, 2048
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.1, 0.05, (b, n))
    mask = (rng.random((b, n)) < 0.85).astype(np.float64)
    h = np.tile(np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]), (b, 1))
    xs = np.zeros((b, 3))
    args = [torch.tensor(a, dtype=torch.float32, device=card)
            for a in (h, x, y, xs, mask, np.full((b,), 0.15))]
    before = blocked_gp._factor_invert.launches
    r = blocked_gp.gp_predict_blocked(*args, jitter=1e-6)
    assert blocked_gp._factor_invert.launches == before + 16  # 4 panels x 4 blocks
    ref = fused_gp.gp_predict_plain(*[a.double() for a in args], jitter=1e-6)
    torch.testing.assert_close(r.mean.double(), ref.mean, atol=1e-4, rtol=0)
    torch.testing.assert_close(r.std.double(), ref.std, atol=1e-4, rtol=0)


def _k3_problem(rng, b, n, card):
    """Rows with masks, differing hypers, one all-padding row, one NaN row."""
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.0, 0.05, (b, n))
    mask = (rng.random((b, n)) < 0.85).astype(np.float64)
    mask[2] = 0.0
    h = np.tile(np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]), (b, 1))
    h[1] += 0.3
    h[-1] = np.nan
    return [torch.tensor(a, dtype=torch.float32, device=card) for a in (h, x, y, mask)]


@pytest.mark.parametrize("kind,n", [(k, 128) for k in Kernel]
                         + [(Kernel.MATERN32, n) for n in (256, 512, 1024)])
def test_k3_matches_twin(card, kind, n):
    args = _k3_problem(np.random.default_rng(n), 6, n, card)
    before = (fused_gp.gp_nll.launches, fused_gp.gp_nll_and_grad.launches)
    v = fused_gp.gp_nll(*args, kind=kind, jitter=1e-6)
    nll, grad = fused_gp.gp_nll_and_grad(*args, kind=kind, jitter=1e-6)
    assert (fused_gp.gp_nll.launches, fused_gp.gp_nll_and_grad.launches) == (
        before[0] + 1, before[1] + 1)
    ref_v, ref_g = fused_gp.gp_nll_and_grad_plain(
        *[a.double() for a in args], kind=kind, jitter=1e-6)
    twin_v, twin_g = fused_gp.gp_nll_and_grad_plain(*args, kind=kind, jitter=1e-6)
    assert torch.equal(v, nll)  # the two variants share the value's arithmetic
    assert torch.isinf(nll[-1]) and nll[-1] > 0 and bool(torch.isnan(grad[-1]).all())
    assert nll[2] == 0 and bool((grad[2] == 0).all())  # all padding: A = I
    ok = slice(0, -1)
    torch.testing.assert_close(nll.double()[ok], ref_v[ok], rtol=1e-5, atol=1e-5)
    # float32 cancellation in Q = A^-1 - alpha alpha^T bounds the gradient:
    # the kernel may deviate as far as a few times the float32 twin does
    dev32 = (twin_g.double() - ref_g)[ok].abs().max().item()
    tol = max(1e-3 * ref_g[ok].abs().max().item(), 4.0 * dev32)
    assert (grad.double() - ref_g)[ok].abs().max().item() <= tol
    again = fused_gp.gp_nll_and_grad(*args, kind=kind, jitter=1e-6)
    assert torch.equal(again[0][ok], nll[ok]) and torch.equal(again[1][ok], grad[ok])


def test_wrappers_refuse_float64_on_card(card):
    with pytest.raises(TypeError):
        blocked_gp._factor_invert(torch.eye(128, dtype=torch.float64, device=card)[None])
    args = [torch.zeros(s, dtype=torch.float64, device=card)
            for s in ((1, 5), (1, 128, 3), (1, 128), (1, 3), (1, 128), (1,))]
    with pytest.raises(TypeError):
        fused_gp.gp_predict(*args)
    with pytest.raises(TypeError):
        fused_gp.gp_nll_and_grad(args[0], args[1], args[2], args[4])


def _k2_problem(rng, b, n, card):
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.1, 0.05, (b, n))
    mask = (rng.random((b, n)) < 0.85).astype(np.float64)
    mask[2] = 0.0
    h = np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]) + rng.normal(0.0, 0.2, (b, 5))
    h[-1] = np.nan
    xs = rng.uniform(-1e5, 1e5, (b, 3)) * np.asarray([1, 1, 0]) + np.asarray([0.0, 0.0, 4.0])
    return [torch.tensor(a, dtype=torch.float32, device=card)
            for a in (h, x, y, xs, mask, np.full((b,), 0.15))]


def _exactly(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("n", [128, 512, 1024])
def test_rows_do_not_depend_on_the_launch(card, n):
    """K3 (both variants) and K2 give a row the same bits whichever rows share
    its launch: one row, and a permuted subset with the all-padding and the
    NaN row, against the full 132-row launch (one CTA per row; the line
    search evaluates subsets of rows and relies on it)."""
    b = 132
    kw = dict(kind=Kernel.MATERN32, jitter=1e-6)
    k3 = _k3_problem(np.random.default_rng(20 + n), b, n, card)
    k2 = _k2_problem(np.random.default_rng(30 + n), b, n, card)
    value = fused_gp.gp_nll(*k3, **kw)
    nll, grad = fused_gp.gp_nll_and_grad(*k3, **kw)
    pred = fused_gp.gp_predict(*k2, **kw)
    for rows in ([0], [5, 1, 2, b - 1, 77, 40, 3, 100]):
        idx = torch.tensor(rows, device=card)
        sub3 = [a[idx].contiguous() for a in k3]
        _exactly(fused_gp.gp_nll(*sub3, **kw), value[idx])
        sub_nll, sub_grad = fused_gp.gp_nll_and_grad(*sub3, **kw)
        _exactly(sub_nll, nll[idx])
        _exactly(sub_grad, grad[idx])
        sub_pred = fused_gp.gp_predict(*[a[idx].contiguous() for a in k2], **kw)
        for got, full in zip(sub_pred, pred):
            _exactly(got, full[idx])
    # the one-row launch is right, not only consistent
    ref_v, ref_g = fused_gp.gp_nll_and_grad_plain(*[a[:1].double() for a in k3], **kw)
    torch.testing.assert_close(nll[:1].double(), ref_v, rtol=1e-5, atol=0)


def _day_like_rows(rng, b, n, card):
    """``b`` cells of a bucket of N = ``n``: 60-100% of the slots valid, the
    rest padding; Matern-3/2 draws (ell 180 / 120 km, 3 days, sf2 0.03, sn2
    0.003) over 300 km and +-3.6 days; the reference x0 as the start."""
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    valid = rng.integers(int(0.6 * n), n + 1, b)
    mask = (np.arange(n)[None] < valid[:, None]).astype(np.float64)
    xs = torch.tensor(x / np.asarray([1.8e5, 1.2e5, 3.0]), device=card)
    r = (xs[:, :, None] - xs[:, None]).square().sum(-1).sqrt() * np.sqrt(3.0)
    k = 0.03 * (1.0 + r) * torch.exp(-r) + 0.003 * torch.eye(n, device=card, dtype=r.dtype)
    z = torch.tensor(rng.standard_normal((b, n, 1)), device=card)
    y = (torch.linalg.cholesky(k) @ z)[:, :, 0].cpu().numpy() * mask
    h = np.tile(np.log([25e3, 25e3, 1.0, 1.0, 0.1]), (b, 1))
    return [torch.tensor(a, dtype=torch.float32, device=card) for a in (h, x, y, mask)]


@pytest.mark.parametrize("n", [512, 1024])
def test_packed_line_search_on_card_is_bit_equal(card, n, monkeypatch):
    """A K3 chunk of 40 day-like cells fitted at launch width 1 (one halving
    a round) and at the card's (its SM count): params, values, iterations
    and convergence bit for bit, with fewer value launches and as many
    gradient launches (a row's bits do not depend on its launch:
    ``test_rows_do_not_depend_on_the_launch``)."""
    from optimalinterpolation_tpu_torch.models import optimizer

    args = _day_like_rows(np.random.default_rng(40 + n), 40, n, card)
    cfg = optimizer.OptimizeConfig(max_iters=60, ftol_abs=1e-3, jitter=1e-6)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert optimizer._launch_width("fused", card) == sms
    assert optimizer._launch_width("blocked", card) == 1

    def fit():
        before = (fused_gp.gp_nll.launches, fused_gp.gp_nll_and_grad.launches,
                  optimizer._line_search.packed_launches)
        res = optimizer.optimize_mll_batch(*args, cfg)
        after = (fused_gp.gp_nll.launches, fused_gp.gp_nll_and_grad.launches,
                 optimizer._line_search.packed_launches)
        return res, [a - b for a, b in zip(after, before)]

    packed, (values, grads, packs) = fit()
    with monkeypatch.context() as mp:
        mp.setattr(optimizer, "_launch_width", lambda backend, device: 1)
        one, (values1, grads1, packs1) = fit()
    for got, want in zip(packed, one):
        assert torch.equal(got, want)
    assert int(one.iters.min()) > 3 and bool(one.converged.any())
    assert packs1 == 0 and packs > 0
    assert values < values1 and grads == grads1, (values, values1, grads, grads1)


def test_k3_ill_conditioned_matern_cell(card):
    """sn2 at 1e-9 sf2, so the diagonal is sf2 (1 + jitter): the condition
    number reaches ~1e6. Value and gradient within the larger of the usual
    gates and 4 x the float32 twin's own deviation; K2 on the same cells
    within 1e-4 m or 4 x its twin."""
    rng = np.random.default_rng(8)
    b, n = 4, 1024
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.0, 0.05, (b, n))
    mask = (rng.random((b, n)) < 0.85).astype(np.float64)
    h = np.tile(np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.03e-9]), (b, 1))
    args = [torch.tensor(a, dtype=torch.float32, device=card) for a in (h, x, y, mask)]
    kw = dict(kind=Kernel.MATERN32, jitter=1e-6)
    nll, grad = fused_gp.gp_nll_and_grad(*args, **kw)
    ref_v, ref_g = fused_gp.gp_nll_and_grad_plain(*[a.double() for a in args], **kw)
    twin_v, twin_g = fused_gp.gp_nll_and_grad_plain(*args, **kw)
    assert bool(torch.isfinite(ref_v).all()) and bool(torch.isfinite(twin_v).all())
    dv = ((nll.double() - ref_v).abs() / ref_v.abs().clamp_min(1.0)).max().item()
    tv = ((twin_v.double() - ref_v).abs() / ref_v.abs().clamp_min(1.0)).max().item()
    assert dv <= max(1e-5, 4.0 * tv)
    dg = (grad.double() - ref_g).abs().max().item()
    tg = (twin_g.double() - ref_g).abs().max().item()
    assert dg <= max(1e-3 * ref_g.abs().max().item(), 4.0 * tg)
    xs = torch.zeros((b, 3), device=card)
    xs[:, 2] = 4.0
    pargs = [args[0], args[1], args[2], xs, args[3], torch.full((b,), 0.15, device=card)]
    r = fused_gp.gp_predict(*pargs, **kw)
    ref = fused_gp.gp_predict_plain(*[a.double() for a in pargs], **kw)
    twin = fused_gp.gp_predict_plain(*pargs, **kw)
    assert bool(r.ok.all()) and bool(ref.ok.all())
    for got, want, t32 in ((r.mean, ref.mean, twin.mean), (r.std, ref.std, twin.std)):
        dev32 = (t32.double() - want).abs().max().item()
        assert (got.double() - want).abs().max().item() <= max(1e-4, 4.0 * dev32)


def _objective_problem(rng, b, n):
    """tests/test_nystroem_backend.py's distribution: smooth targets, valid
    points first, 90% of the slots valid, hypers near the generating ones."""
    x = rng.uniform(-3e5, 3e5, size=(b, n, 3))
    x[..., 2] = rng.uniform(0, 9, size=(b, n))
    mask = np.zeros((b, n))
    mask[:, : int(0.9 * n)] = 1.0
    y = (0.1 * np.sin(x[..., 0] / 1.5e5) + 0.05 * np.cos(x[..., 1] / 1.2e5)
         + 0.03 * rng.standard_normal((b, n)))
    h = np.tile(np.log([2.0e5, 2.0e5, 2.0, 0.02, 0.002]), (b, 1))
    h += 0.1 * rng.standard_normal((b, 5))
    return h, x, y, mask


_OBJECTIVES = {
    "blocked": blocked_gp.gp_nll_and_grad_blocked,
    "nystroem": lambda *a, **kw: nystroem_gp.gp_nll_and_grad_nystroem(*a, 512, **kw),
}


@pytest.mark.parametrize("name, n", [("blocked", 1024), ("blocked", 2048),
                                     ("nystroem", 1024), ("nystroem", 2048)])
def test_objective_float32_on_card_matches_float64(card, name, n):
    """Value within 1e-5 relative and gradient within 1e-3 relative in norm
    of the same function in float64 on the CPU, on the float32-rounded
    inputs; K1 launched (the blocked path: one launch a diagonal block;
    Nystrom: 4 a chol_inv, twice)."""
    args32 = [torch.tensor(a, dtype=torch.float32, device=card)
              for a in _objective_problem(np.random.default_rng(n), 3, n)]
    fn = _OBJECTIVES[name]
    before = blocked_gp._factor_invert.launches
    v, g = fn(*args32, jitter=1e-6)
    torch.cuda.synchronize()
    want = n // 128 if name == "blocked" else 8
    assert blocked_gp._factor_invert.launches == before + want
    v64, g64 = fn(*[a.cpu().double() for a in args32], jitter=1e-6)
    assert bool(torch.isfinite(v64).all())
    dv = ((v.cpu().double() - v64).abs() / v64.abs()).max().item()
    dg = (torch.linalg.vector_norm(g.cpu().double() - g64, dim=1)
          / torch.linalg.vector_norm(g64, dim=1)).max().item()
    assert dv <= 1e-5, dv
    assert dg <= 1e-3, dg


def test_chol_inv_on_card_launches_k1_not_the_library(card, monkeypatch):
    """Forward and backward of chol_inv at M = 512 on the card: 4 K1
    launches, no library Cholesky (torch.linalg.cholesky_ex raises here),
    and the gradient of the float64 CPU run to 1e-3 relative."""
    def refuse(*a, **kw):
        raise AssertionError("a library Cholesky ran on the card")

    rng = np.random.default_rng(9)
    g0 = rng.standard_normal((2, 512, 512)) / np.sqrt(512)
    a = g0 @ g0.transpose(0, 2, 1) + np.eye(512)
    c = rng.standard_normal((2, 512, 512))
    monkeypatch.setattr(torch.linalg, "cholesky_ex", refuse)
    monkeypatch.setattr(torch.linalg, "cholesky", refuse)
    grads = []
    for dev, dt in ((card, torch.float32), ("cpu", torch.float64)):
        at = torch.tensor(a, dtype=dt, device=dev, requires_grad=True)
        before = blocked_gp._factor_invert.launches
        if dev == "cpu":  # the plain twin needs the library on the CPU
            monkeypatch.undo()
        l, w, logdet, ok = nystroem_gp.chol_inv(at)
        loss = (torch.tensor(c, dtype=dt, device=dev) * w).sum() + logdet.sum()
        (g,) = torch.autograd.grad(loss, at)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert blocked_gp._factor_invert.launches == before + 4 and bool(ok.all())
        grads.append(g.cpu().double())
    err = (grads[0] - grads[1]).norm() / grads[1].norm()
    assert err.item() <= 1e-3, err.item()


@pytest.mark.parametrize("name", list(_OBJECTIVES))
def test_objectives_refuse_tf32(card, name):
    args = [torch.tensor(a, dtype=torch.float32, device=card)
            for a in _objective_problem(np.random.default_rng(1), 1, 1024)]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            _OBJECTIVES[name](*args, jitter=1e-6)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_wave_matches_serial_days_on_card(card, tmp_path):
    """tests/test_multiday.py's wave season and ``_CFG`` (buckets (128,
    256)) in float32 on the card: a wave of windows 0 and 2 gives every one
    of the 15 fields of each day bit for bit as the day run alone. At these
    buckets only K2 and K3 run (no K1), a row's bits do not depend on the
    rows that share its launch (``test_rows_do_not_depend_on_the_launch``),
    and the optimizer's updates are row by row, so equality is required."""
    from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season
    from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season
    from optimalinterpolation_tpu_torch.models.optimizer import OptimizeConfig
    from optimalinterpolation_tpu_torch.pipeline.daily import DailyConfig, interpolate_daily
    from optimalinterpolation_tpu_torch.pipeline.multiday import interpolate_days

    make_synthetic_season(str(tmp_path), grid_res_km=125, n_days=12, seed=5, noise_std=0.03,
                          tracks_per_day=(5, 2, 4, 4))
    ds = read_freeboard_season(str(tmp_path), 125, "2018-2019")
    thin = np.ones(ds.sie.shape[:2], bool)  # keep every 4th cell, as the wave season
    thin[::4, ::4] = False
    ds.sie[thin] = np.nan
    cfg = DailyConfig(window_days=9, radius_km=450.0, buckets=(128, 256), dtype="float32",
                      opt=OptimizeConfig(max_iters=10, nystroem_min_n=0), warmstart_n=0,
                      spatial_seed_stride=0)
    days = [0, 2]
    counted = (blocked_gp._factor_invert, fused_gp.gp_predict, fused_gp.gp_nll,
               fused_gp.gp_nll_and_grad)
    before = [fn.launches for fn in counted]
    serial = [interpolate_daily(ds, d, 0.15, cfg, device=card).to_reference_dict() for d in days]
    wave = [r.to_reference_dict() for r in interpolate_days(ds, days, [0.15] * 2, cfg,
                                                             device=card)]
    launched = [fn.launches - b for fn, b in zip(counted, before)]
    assert launched[0] == 0 and min(launched[1:]) > 0, launched
    for w, s in zip(wave, serial):
        assert list(w) == list(s) and len(w) == 15
        interp = next(v for k, v in w.items() if k.endswith("_interp_smth"))
        assert np.isfinite(interp).sum() > 20
        for key in s:
            np.testing.assert_array_equal(w[key], s[key], err_msg=key)


def test_quicklook_day_profile_on_card_names_k1_and_k2(card, tmp_path):
    """``daily --hypers H --profile LOGDIR`` on the card: a 100 km season at
    a 600 km radius fills the 512-4096 buckets, so the quicklook day runs
    K2 (N <= 1024) and K1 (the blocked predicts of N = 2048 and 4096). The
    Chrome trace under LOGDIR holds one kernel event of each name for each
    launch counted, and no K3."""
    import json
    import os

    from optimalinterpolation_tpu_torch import cli
    from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season

    d = str(tmp_path)
    make_synthetic_season(d, grid_res_km=100, n_days=9, seed=7, noise_std=0.1,
                          tracks_per_day=(10, 3, 8, 8))
    npz = os.path.join(d, "hypers.npz")
    np.savez(npz, **{k: np.full((80, 80), v) for k, v in
                     dict(ell_x=2e5, ell_y=2e5, ell_t=2.0, sf2=0.03, sn2=0.005).items()})
    logdir = os.path.join(d, "prof")
    counted = (blocked_gp._factor_invert, fused_gp.gp_predict, fused_gp.gp_nll,
               fused_gp.gp_nll_and_grad)
    before = [fn.launches for fn in counted]
    cli.main(["daily", "--datapath", d, "--grid-res", "100", "--radius-km", "600",
              "--prior-mean", "0.15", "--hypers", npz, "--profile", logdir, "--outdir", d])
    k1, k2, k3v, k3g = [fn.launches - b for fn, b in zip(counted, before)]
    assert k1 > 0 and k2 > 0 and k3v == k3g == 0
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    assert sum("k1_factor_invert_kernel" in n for n in kernels) == k1
    assert sum("k2_predict_kernel" in n for n in kernels) == k2
    assert not any("k3_nll_kernel" in n for n in kernels)


def test_adam_chunk_on_card_follows_the_twin(card):
    """One Adam chunk through K3 (N = 512): 30 value + gradient launches and
    one value launch, and the float32 fit on the card ends where the float32
    twin's does on the CPU (log-hypers within 1e-3, NLL within 1e-4
    relative: Adam's normalized steps carry float32 rounding, not amplify
    it); the NaN row stays NaN."""
    from optimalinterpolation_tpu_torch.models.optimizer import OptimizeConfig, optimize_mll_batch

    h, x, y, m = _k3_problem(np.random.default_rng(11), 8, 512, card)
    h = h.clone()
    h[:-1] = torch.log(torch.tensor([25e3, 25e3, 1.0, 1.0, 0.1], device=card))
    cfg = OptimizeConfig(method="adam", max_iters=30, jitter=1e-6)
    before = (fused_gp.gp_nll.launches, fused_gp.gp_nll_and_grad.launches)
    got = optimize_mll_batch(h, x, y, m, cfg)
    assert (fused_gp.gp_nll.launches - before[0], fused_gp.gp_nll_and_grad.launches
            - before[1]) == (1, 30)
    twin = optimize_mll_batch(*(a.cpu() for a in (h, x, y, m)), cfg)
    ok = slice(0, -1)
    torch.testing.assert_close(got.log_hypers.cpu()[ok], twin.log_hypers[ok], rtol=0, atol=1e-3)
    torch.testing.assert_close(got.nll.cpu()[ok], twin.nll[ok], rtol=1e-4, atol=1e-4)
    assert bool(torch.isnan(got.log_hypers[-1]).all())
    assert (got.iters == 30).all()


def test_cell_command_on_card(card, tmp_path):
    """``cell`` on the card, float32, at a 100 km season's cell with a
    300 km radius (464 points, the 512 bucket): exact (L-BFGS through K3,
    and Adam), Nystrom (BFGS) and a short SVGP give finite means and
    std > 0, Nystrom within 0.05 m of the exact mean; the exact fits launch
    K3, the others none of the kernels."""
    import contextlib
    import io
    import json

    from optimalinterpolation_tpu_torch import cli
    from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season

    d = str(tmp_path)
    make_synthetic_season(d, grid_res_km=100, n_days=9, seed=7, noise_std=0.1,
                          tracks_per_day=(10, 3, 8, 8))
    base = ["cell", "--datapath", d, "--grid-res", "100", "--radius-km", "300",
            "--prior-mean", "0.15", "--x", "4e6", "--y", "3.5e6", "--max-iters", "30"]
    counted = (blocked_gp._factor_invert, fused_gp.gp_predict, fused_gp.gp_nll,
               fused_gp.gp_nll_and_grad)
    lines, launched = {}, {}
    for name, extra in (("exact", []), ("adam", ["--optimizer", "adam"]),
                        ("nystroem", ["--method", "nystroem", "--landmarks", "128"]),
                        ("svgp", ["--method", "svgp", "--svgp-iters", "300"])):
        before = [fn.launches for fn in counted]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(base + extra)
        lines[name] = json.loads(out.getvalue().strip().splitlines()[-1])
        launched[name] = [fn.launches - b for fn, b in zip(counted, before)]
    assert lines["exact"]["n_points"] > 100
    assert launched["exact"][2] > 0 and launched["exact"][3] > 0
    assert launched["adam"][2:] == [1, 30]
    assert launched["nystroem"] == launched["svgp"] == [0, 0, 0, 0]
    for name, line in lines.items():
        assert np.isfinite(line["mean"]) and line["std"] > 0, name
    assert abs(lines["nystroem"]["mean"] - lines["exact"]["mean"]) < 0.05, lines


def test_sharded_day_on_card_matches_one_shard(card, tmp_path):
    """tests/test_multiday.py's season and ``_CFG`` (buckets (128, 256), K2
    and K3 only) in float32: window 0 on two shards of ``cuda:0``
    (``make_mesh(devices=["cuda:0", "cuda:0"])``, two threads, two streams)
    gives every one of the 15 fields bit for bit as the unsharded day: a
    row's bits do not depend on the rows that share its launch. Each
    shard's stream carries K2, K3 value and K3 gradient launches, and each
    wrapper's launches by stream add up to its launches."""
    import collections

    from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season
    from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season
    from optimalinterpolation_tpu_torch.models.optimizer import OptimizeConfig
    from optimalinterpolation_tpu_torch.parallel.mesh import cell_sharding, make_mesh
    from optimalinterpolation_tpu_torch.pipeline.daily import DailyConfig, interpolate_daily

    make_synthetic_season(str(tmp_path), grid_res_km=125, n_days=9, seed=5, noise_std=0.03,
                          tracks_per_day=(5, 2, 4, 4))
    ds = read_freeboard_season(str(tmp_path), 125, "2018-2019")
    cfg = DailyConfig(window_days=9, radius_km=450.0, buckets=(128, 256), dtype="float32",
                      opt=OptimizeConfig(max_iters=10, nystroem_min_n=0), warmstart_n=0,
                      spatial_seed_stride=0)
    one = interpolate_daily(ds, 0, 0.15, cfg, device=card).to_reference_dict()
    sharding = cell_sharding(make_mesh(devices=["cuda:0", "cuda:0"]))
    counted = (fused_gp.gp_predict, fused_gp.gp_nll, fused_gp.gp_nll_and_grad)
    before = [(fn.launches, collections.Counter(fn.streams)) for fn in counted]
    two = interpolate_daily(ds, 0, 0.15, cfg, cell_sharding=sharding).to_reference_dict()
    torch.cuda.synchronize()
    streams = [sharding.stream(i).cuda_stream for i in range(2)]
    assert len(set(streams)) == 2
    for fn, (n0, s0) in zip(counted, before):
        by_stream = fn.streams - s0
        assert sum(by_stream.values()) == fn.launches - n0 > 0
        assert all(by_stream[s] > 0 for s in streams), (fn.__name__, by_stream)
    assert list(two) == list(one) and len(two) == 15
    interp = next(v for k, v in two.items() if k.endswith("_interp_smth"))
    assert np.isfinite(interp).sum() > 100
    for key in one:
        np.testing.assert_array_equal(two[key], one[key], err_msg=key)
