"""The port's single-cell Nystrom model (``models/nystroem.py``) against the
JAX package's, float64 on the CPU.

Same cells as tests/test_nystroem.py (seeded numpy draws from the
Matern-3/2 GP), padded, with landmarks given as indices of valid points:
the NLL in both determinant conventions, its autograd gradient against
``jax.grad`` and the predict agree to 1e-10 relative. Then the JAX test's
cases through the port: full rank is the exact GP, the error falls with M,
and padding changes nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalinterpolation_tpu.models import nystroem as JN
from optimalinterpolation_tpu_torch.models import exact_gp
from optimalinterpolation_tpu_torch.models import nystroem as TN

from . import oracle

LOG_H = np.log(np.array([2.0e5, 1.5e5, 2.5, 0.03, 0.004]))


def _cell(rng, n=120):
    x = rng.uniform(-3e5, 3e5, size=(n, 3)) * np.asarray([1, 1, 1.2e-5])
    k = oracle.matern32_gram(x, np.exp(LOG_H[:3]), np.exp(LOG_H[3]))
    y = rng.multivariate_normal(np.zeros(n), k + np.exp(LOG_H[4]) * np.eye(n))
    return x, y


def _padded(seed, n=90, pad=38, m=40):
    rng = np.random.default_rng(seed)
    x, y = _cell(rng, n)
    xp = np.concatenate([x, rng.normal(size=(pad, 3)) * 1e5])
    yp = np.concatenate([y, np.full(pad, 7.0)])
    mask = np.concatenate([np.ones(n), np.zeros(pad)])
    lm = np.sort(rng.choice(n, m, replace=False))
    return xp, yp, mask, lm


def _t(*a):
    return [torch.tensor(v) for v in a]


@pytest.mark.parametrize("ref_det", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_nll_and_gradient_match_jax(seed, ref_det):
    x, y, mask, lm = _padded(seed)
    h = LOG_H + np.random.default_rng(seed + 10).normal(scale=0.3, size=5)

    def jf(hh):
        return JN.nystroem_nll(hh, jnp.asarray(x), jnp.asarray(y), jnp.asarray(lm),
                               jnp.asarray(mask), jitter=1e-6, ref_det_convention=ref_det)

    ref, jgrad = jax.value_and_grad(jf)(jnp.asarray(h))
    ht = torch.tensor(h, requires_grad=True)
    got = TN.nystroem_nll(ht, *_t(x, y, lm, mask), jitter=1e-6, ref_det_convention=ref_det)
    (g,) = torch.autograd.grad(got, ht)
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(jgrad)).max())


def test_predict_matches_jax():
    x, y, mask, lm = _padded(2)
    xstar = np.array([[1e4, -2e4, 4.0], [-1e5, 5e4, 1.0]])
    ref = JN.nystroem_predict(jnp.asarray(LOG_H), jnp.asarray(x), jnp.asarray(y + 0.1),
                              jnp.asarray(xstar), jnp.asarray(lm), jnp.asarray(mask), 0.1,
                              jitter=1e-6)
    got = TN.nystroem_predict(torch.tensor(LOG_H), *_t(x, y + 0.1, xstar, lm, mask), 0.1,
                              jitter=1e-6)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), rtol=1e-10)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(ref.std), rtol=1e-10)
    assert bool(got.ok) and bool(ref.ok)


def test_failed_factor_gives_inf_and_nan():
    """A NaN hyperparameter: JAX's factor is NaN, the port's ``cholesky_ex``
    fails without raising; both give an infinite NLL and NaN predictions."""
    x, y, mask, lm = _padded(3)
    h = LOG_H.copy()
    h[3] = np.nan
    ref = JN.nystroem_nll(jnp.asarray(h), jnp.asarray(x), jnp.asarray(y), jnp.asarray(lm),
                          jnp.asarray(mask))
    got = TN.nystroem_nll(torch.tensor(h), *_t(x, y, lm, mask))
    assert np.isinf(float(ref)) and torch.isinf(got)
    pred = TN.nystroem_predict(torch.tensor(h), *_t(x, y, np.zeros((1, 3)), lm, mask), 0.1)
    assert not bool(pred.ok) and torch.isnan(pred.mean).all() and torch.isnan(pred.std).all()


def test_full_rank_matches_exact():
    """With M = n landmarks the Nystrom approximation is exact."""
    x, y = _cell(np.random.default_rng(11), n=60)
    lm, ones = torch.arange(60), torch.ones(60, dtype=torch.float64)
    xt, yt, h = torch.tensor(x), torch.tensor(y), torch.tensor(LOG_H)
    approx = TN.nystroem_nll(h, xt, yt, lm, ones)
    exact = exact_gp.neg_log_marginal_likelihood(h, xt, yt, ones)
    np.testing.assert_allclose(float(approx), float(exact), rtol=1e-6)
    xstar = torch.tensor([[1e4, -2e4, 4.0]])
    pn = TN.nystroem_predict(h, xt, yt + 0.1, xstar, lm, ones, 0.1)
    pe = exact_gp.predict(h, xt, yt + 0.1, xstar, ones, 0.1)
    np.testing.assert_allclose(float(pn.mean[0]), float(pe.mean[0]), atol=1e-6)
    np.testing.assert_allclose(float(pn.std[0]), float(pe.std[0]), atol=1e-5)


def test_low_rank_converges_to_exact():
    local = np.random.default_rng(1234)
    log_h = np.log(np.array([4.0e5, 4.0e5, 6.0, 0.03, 0.004]))
    n = 150
    x = local.uniform(-3e5, 3e5, size=(n, 3)) * np.asarray([1, 1, 1.2e-5])
    k = oracle.matern32_gram(x, np.exp(log_h[:3]), np.exp(log_h[3]))
    y = local.multivariate_normal(np.zeros(n), k + np.exp(log_h[4]) * np.eye(n))
    xt, yt, h = torch.tensor(x), torch.tensor(y) + 0.1, torch.tensor(log_h)
    ones, xstar = torch.ones(n, dtype=torch.float64), torch.tensor([[0.0, 0.0, 4.0]])
    pe = exact_gp.predict(h, xt, yt, xstar, ones, 0.1)
    errs = {}
    for m in (50, 100, 150):
        lm = torch.tensor(sorted(local.choice(150, m, replace=False)))
        pn = TN.nystroem_predict(h, xt, yt, xstar, lm, ones, 0.1)
        errs[m] = (abs(float(pn.mean[0]) - float(pe.mean[0])),
                   abs(float(pn.std[0]) - float(pe.std[0])))
    assert errs[150][0] < 1e-6 and errs[150][1] < 1e-5
    assert errs[100][0] < 0.05 and errs[100][1] < 0.03
    assert errs[100][1] <= errs[50][1] + 1e-6
    assert errs[100][0] <= errs[50][0] + 1e-6


def test_padding_invariance():
    rng = np.random.default_rng(12)
    x, y = _cell(rng, n=40)
    lm = torch.tensor(sorted(rng.choice(40, 20, replace=False)))
    h = torch.tensor(LOG_H)
    base = TN.nystroem_nll(h, torch.tensor(x), torch.tensor(y), lm,
                           torch.ones(40, dtype=torch.float64))
    xp = np.concatenate([x, rng.normal(size=(24, 3)) * 1e5])
    yp = np.concatenate([y, np.full(24, 7.0)])
    mask = np.concatenate([np.ones(40), np.zeros(24)])
    padded = TN.nystroem_nll(h, *_t(xp, yp), lm, torch.tensor(mask))
    np.testing.assert_allclose(float(padded), float(base), rtol=1e-8)
