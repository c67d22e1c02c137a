"""Port ``ops/nystroem_gp.py`` (the rank-M Nystrom objective) against JAX, float64.

The six cases of tests/test_nystroem_backend.py, each on the same numpy
inputs through both packages: the ``chol_inv`` backward against autograd
through ``torch.linalg.cholesky`` (1e-9) and against JAX's custom VJP; value
(rtol 1e-10) and gradient (rtol 1e-7 or atol 1e-9) against JAX and the dense
Woodbury oracle; padding invariance; masked landmarks; the full-rank limit;
and the prediction parity of Nystrom-fitted hypers (|d mean| < 5e-4,
|d std| < 2e-3, JAX's bounds). On the CPU ``chol_inv`` runs K1's plain twin;
K1 under it is held on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalinterpolation_tpu.ops import nystroem_gp as JN
from optimalinterpolation_tpu_torch.models import exact_gp as TE
from optimalinterpolation_tpu_torch.models import optimizer as TO
from optimalinterpolation_tpu_torch.models.exact_gp_batch import predict_batch
from optimalinterpolation_tpu_torch.ops import nystroem_gp as TN

from .test_nystroem_backend import X0, _oracle_nll


def _problem(seed, b=3, n=256, n_valid=None, ell=(1.5e5, 1.2e5, 2.0)):
    """tests/test_nystroem_backend.py::_problem's distribution, valid points
    first, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3e5, 3e5, size=(b, n, 3))
    x[..., 2] = rng.uniform(0, 9, size=(b, n))
    mask = np.zeros((b, n))
    mask[:, : n_valid or n] = 1.0
    y = (0.1 * np.sin(x[..., 0] / ell[0]) + 0.05 * np.cos(x[..., 1] / ell[1])
         + 0.03 * rng.standard_normal((b, n)))
    h = np.tile(np.log([2.0e5, 2.0e5, 2.0, 0.02, 0.002]), (b, 1))
    h += 0.1 * rng.standard_normal((b, 5))
    return h, x, y, mask


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_chol_inv_backward_matches_autograd_and_jax():
    """M = 256: the panel recursion. Cotangents on L, W and logdet."""
    rng = np.random.default_rng(0)
    b, m = 2, 256
    p0 = rng.standard_normal((b, m, m)) / np.sqrt(m)
    cl, cw = rng.standard_normal((2, b, m, m))
    cd = rng.standard_normal(b)
    eye = torch.eye(m, dtype=torch.float64)

    def build(p):
        sym = p + p.mT
        return sym @ sym.mT + 2.0 * eye

    def loss(p, ours):
        a = build(p)
        if ours:
            l, w, logdet, _ = TN.chol_inv(a)
        else:
            l = torch.linalg.cholesky(a)
            w = torch.linalg.solve_triangular(l, eye.expand_as(l), upper=False)
            logdet = l.diagonal(dim1=1, dim2=2).log().sum(dim=1)
        return (cl_t * l).sum() + (cw_t * w).sum() + (cd_t * logdet).sum()

    cl_t, cw_t, cd_t = _t(cl, cw, cd)
    grads = []
    for ours in (True, False):
        p = torch.tensor(p0, requires_grad=True)
        (g,) = torch.autograd.grad(loss(p, ours), p)
        grads.append(g.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=0, atol=1e-9)

    def jloss(p):
        sym = p + jnp.swapaxes(p, 1, 2)
        a = jnp.einsum("bij,bkj->bik", sym, sym) + 2.0 * jnp.eye(m)[None]
        l, w, logdet, _ = JN.chol_inv(a)
        return jnp.sum(cl * l) + jnp.sum(cw * w) + jnp.sum(cd * logdet)

    np.testing.assert_allclose(grads[0], np.asarray(jax.grad(jloss)(jnp.asarray(p0))),
                               rtol=0, atol=1e-9)


def test_nll_and_grad_match_jax_and_dense_oracle():
    mi, jitter = 128, 1e-6
    h, x, y, mask = _problem(1, b=3, n=384, n_valid=300)
    nll = TN.gp_nll_nystroem(*_t(h, x, y, mask), mi, jitter=jitter).numpy()
    nll2, grad = (a.numpy() for a in TN.gp_nll_and_grad_nystroem(*_t(h, x, y, mask), mi,
                                                                 jitter=jitter))
    jv, jg = JN.gp_nll_and_grad_nystroem(*_j(h, x, y, mask), mi, jitter=jitter)
    np.testing.assert_array_equal(nll, nll2)
    np.testing.assert_allclose(nll, np.asarray(jv), rtol=1e-10, atol=0)
    np.testing.assert_allclose(grad, np.asarray(jg), rtol=1e-7, atol=1e-9)
    # the dense oracle, eagerly (its valid count is a Python int): one row
    o, go = jax.value_and_grad(_oracle_nll)(*_j(h[0], x[0], y[0], mask[0]), mi, jitter)
    np.testing.assert_allclose(nll[0], float(o), rtol=1e-9)
    np.testing.assert_allclose(grad[0], np.asarray(go), rtol=1e-7, atol=1e-9)


def test_padding_invariance():
    mi = 128
    h, x, y, mask = _problem(2, b=2, n=256, n_valid=200)
    pad = [np.concatenate([a, np.zeros((2, 128) + a.shape[2:])], axis=1) for a in (x, y, mask)]
    small = TN.gp_nll_nystroem(*_t(h, x, y, mask), mi, jitter=1e-6).numpy()
    bigger = TN.gp_nll_nystroem(*_t(h, *pad), mi, jitter=1e-6).numpy()
    np.testing.assert_allclose(bigger, small, rtol=1e-12)
    np.testing.assert_allclose(
        bigger, np.asarray(JN.gp_nll_nystroem(*_j(h, *pad), mi, jitter=1e-6)), rtol=1e-10)


def test_masked_landmarks_match_fewer_landmarks():
    """n_valid = 100 < M = 128: the 28 masked landmark slots drop out exactly
    (identity in Amm, zero Phi columns): the oracle with the 100 valid
    landmarks."""
    h, x, y, mask = _problem(3, b=2, n=256, n_valid=100)
    nll = TN.gp_nll_nystroem(*_t(h, x, y, mask), 128, jitter=1e-6).numpy()
    assert np.isfinite(nll).all()
    np.testing.assert_allclose(
        nll, np.asarray(JN.gp_nll_nystroem(*_j(h, x, y, mask), 128, jitter=1e-6)), rtol=1e-10)
    for i in range(2):
        o = _oracle_nll(*_j(h[i], x[i], y[i], mask[i]), 100, 1e-6)
        np.testing.assert_allclose(nll[i], float(o), rtol=1e-9)


def test_full_rank_limits_to_exact():
    """M = n_valid: the exact NLL up to the O(_MM_JITTER) regularization of
    Kmm (the JAX test's bound), and the JAX value to 1e-10."""
    h, x, y, mask = _problem(4, b=2, n=128, n_valid=128)
    nys = TN.gp_nll_nystroem(*_t(h, x, y, mask), 128, jitter=1e-6).numpy()
    exact = TE.neg_log_marginal_likelihood(*_t(h, x, y, mask), jitter=1e-6).numpy()
    assert np.all(np.abs(nys - exact) < 5e-3 * np.abs(exact) + 0.5), (nys, exact)
    np.testing.assert_allclose(
        nys, np.asarray(JN.gp_nll_nystroem(*_j(h, x, y, mask), 128, jitter=1e-6)), rtol=1e-10)


def test_nystroem_hypers_prediction_parity():
    """Fit one batch on the exact objective and on the Nystrom one: the exact
    predictions at either hyper set agree within JAX's bounds (the JAX
    package's Nystrom trajectory is held in tests/test_torch_optimizer.py)."""
    b, n, mi = 4, 512, 256
    _, x, y, mask = _problem(5, b=b, n=n, n_valid=480)
    h0 = np.tile(X0[None], (b, 1))
    xstar = np.concatenate([x[:, :1, :2].mean(axis=1), np.full((b, 1), 4.5)], axis=1)
    kw = dict(max_iters=40, grad_tol=1e-5, jitter=1e-6)
    r_exact = TO.optimize_mll_batch(*_t(h0, x, y, mask), TO.OptimizeConfig(backend="xla", **kw))
    r_nys = TO.optimize_mll_batch(*_t(h0, x, y, mask),
                                  TO.OptimizeConfig(backend="nystroem", nystroem_m=mi, **kw))
    data = _t(x, y, xstar, mask, np.zeros(b))
    p_exact = predict_batch(r_exact.log_hypers, *data, jitter=1e-6)
    p_nys = predict_batch(r_nys.log_hypers, *data, jitter=1e-6)
    dm = (p_exact.mean - p_nys.mean).abs().numpy()
    ds = (p_exact.std - p_nys.std).abs().numpy()
    assert np.isfinite(dm).all()
    assert dm.max() < 5e-4, dm  # < 0.5 mm on ~0.1 m freeboards
    assert ds.max() < 2e-3, ds


def test_m_inducing_must_be_a_multiple_of_128():
    h, x, y, mask = _problem(6, b=1, n=256)
    with pytest.raises(ValueError, match="multiple of 128"):
        TN.gp_nll_nystroem(*_t(h, x, y, mask), 100)


def test_nonfinite_row_gives_inf_and_nan_gradient():
    """A NaN-hyper row: value +inf, gradient NaN; the other rows unchanged."""
    h, x, y, mask = _problem(7, b=3, n=256, n_valid=230)
    bad = h.copy()
    bad[1] = np.nan
    v, g = TN.gp_nll_and_grad_nystroem(*_t(bad, x, y, mask), 128, jitter=1e-6)
    v_ok, g_ok = TN.gp_nll_and_grad_nystroem(*_t(h, x, y, mask), 128, jitter=1e-6)
    assert torch.isinf(v[1]) and v[1] > 0 and torch.isnan(g[1]).all()
    keep = [0, 2]
    torch.testing.assert_close(v[keep], v_ok[keep], rtol=0, atol=0)
    torch.testing.assert_close(g[keep], g_ok[keep], rtol=1e-12, atol=0)


def test_plain_factor_matches_chol_inv():
    """``factor=chol_inv_plain`` (one library Cholesky of each (M, M)
    matrix, autograd) gives chol_inv's value and gradient, a NaN row's inf
    and NaN gradient included."""
    h, x, y, mask = _problem(8, b=3, n=384, n_valid=330)
    h[2] = np.nan
    v, g = TN.gp_nll_and_grad_nystroem(*_t(h, x, y, mask), 256, jitter=1e-6)
    vp, gp = TN.gp_nll_and_grad_nystroem(*_t(h, x, y, mask), 256, jitter=1e-6,
                                         factor=TN.chol_inv_plain)
    np.testing.assert_allclose(vp.numpy(), v.numpy(), rtol=1e-11, atol=0)
    np.testing.assert_allclose(gp[:2].numpy(), g[:2].numpy(), rtol=1e-8, atol=1e-10)
    assert torch.isinf(vp[2]) and torch.isnan(gp[2]).all()
    vv = TN.gp_nll_nystroem(*_t(h, x, y, mask), 256, jitter=1e-6, factor=TN.chol_inv_plain)
    torch.testing.assert_close(vv, vp, rtol=0, atol=0)
