"""The port's SVGP (``models/svgp.py``) against the JAX package's, float64
on the CPU.

Same cells as tests/test_svgp.py (seeded numpy draws from the Matern-3/2
GP). ``svgp_init`` is equal, the ELBO and its gradient agree to 1e-10
relative, and 50 Adam steps on one numpy array of minibatch indices end
within 1e-8 of a loop built from the JAX package's own ``elbo`` and
``optax.adam`` (the port steps with ``torch.optim.Adam``: the same
arithmetic in another order). ``svgp_predict`` is equal. Then the JAX
test's properties through the port with a ``torch.Generator``: KL 0 at the
prior, the ELBO below the exact log marginal likelihood, padding excluded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from optimalinterpolation_tpu.models import svgp as JS
from optimalinterpolation_tpu_torch.models import exact_gp
from optimalinterpolation_tpu_torch.models import svgp as TS

from . import oracle

LOG_H = np.log(np.array([1.8e5, 1.8e5, 3.0, 0.03, 0.004]))
X0 = np.log(np.array([25e3, 25e3, 1.0, 1.0, 0.1]))  # reference init


def _cell(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3e5, 3e5, size=(n, 3)) * np.asarray([1, 1, 1.2e-5])
    k = oracle.matern32_gram(x, np.exp(LOG_H[:3]), np.exp(LOG_H[3]))
    y = 0.15 + rng.multivariate_normal(np.zeros(n), k + np.exp(LOG_H[4]) * np.eye(n))
    return x, y


def _padded(seed, n=80, pad=48):
    x, y = _cell(seed, n)
    return (np.concatenate([x, np.zeros((pad, 3))]), np.concatenate([y, np.full(pad, 99.0)]),
            np.concatenate([np.ones(n), np.zeros(pad)]))


def _params(seed, m=16):
    """A variational state away from the prior: every field moved."""
    x, _, mask = _padded(seed)
    rng = np.random.default_rng(seed + 100)
    p = JS.svgp_init(jnp.asarray(x), jnp.asarray(mask), m, jnp.asarray(LOG_H), 0.15)
    return p._replace(nu=jnp.asarray(rng.normal(size=m)),
                      s=p.s + 0.1 * jnp.asarray(rng.normal(size=(m, m))),
                      z=p.z * (1 + 0.01 * jnp.asarray(rng.normal(size=(m, 3)))))


def _np(p):
    return {f: np.asarray(getattr(p, f)) for f in JS.SVGPParams._fields}


def test_init_equal():
    x, _, mask = _padded(3)
    ref = JS.svgp_init(jnp.asarray(x), jnp.asarray(mask), 16, jnp.asarray(X0), 0.15)
    got = TS.svgp_init(torch.tensor(x), torch.tensor(mask), 16, torch.tensor(X0), 0.15)
    for f in TS.SVGPParams._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-15, atol=0, err_msg=f)
    assert np.isfinite(got.z.numpy()).all()  # the range comes from valid points only


def test_elbo_and_gradient_match_jax():
    x, y, mask = _padded(4)
    jp = _params(4)
    idx = np.random.default_rng(5).integers(0, 128, 64)
    kind, jitter = JS.SVGPConfig().kind, 1e-6

    def jelbo(p):
        return JS.elbo(p, jnp.asarray(x[idx]), jnp.asarray(y[idx]), jnp.asarray(mask[idx]),
                       jnp.asarray(mask.sum()), kind, jitter)

    ref, jgrad = jax.value_and_grad(jelbo)(jp)
    tp = [p.requires_grad_() for p in TS.svgp_params_from_numpy(jp)]
    got = TS.elbo(TS.SVGPParams(*tp), *(torch.tensor(a[idx]) for a in (x, y, mask)),
                  torch.tensor(mask.sum()), kind, jitter)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-10)
    for f, p in zip(TS.SVGPParams._fields, tp):
        g = np.asarray(getattr(jgrad, f))
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-10, atol=1e-10 * np.abs(g).max(),
                                   err_msg=f)


def test_adam_trajectory_matches_optax():
    """50 steps on the same minibatch indices: the port's ``svgp_fit``
    against a loop of ``optax.adam`` on the JAX package's ELBO."""
    x, y, mask = _padded(6)
    cfg = JS.SVGPConfig(num_inducing=16, iterations=50, batch_size=32, learning_rate=1e-2,
                        elbo_log_every=5)
    idx = np.random.default_rng(7).choice(80, size=(cfg.iterations, cfg.batch_size))
    p = JS.svgp_init(jnp.asarray(x), jnp.asarray(mask), 16, jnp.asarray(X0), 0.15)
    opt = optax.adam(cfg.learning_rate)
    state = opt.init(p)
    n_data = jnp.asarray(mask.sum())
    elbos = []
    for t in range(cfg.iterations):
        xb, yb, wb = (jnp.asarray(a[idx[t]]) for a in (x, y, mask))
        value, g = jax.value_and_grad(JS.elbo)(p, xb, yb, wb, n_data, cfg.kind, cfg.jitter)
        g = jax.tree.map(lambda a: -jnp.where(jnp.isfinite(a), a, 0.0), g)
        upd, state = opt.update(g, state, p)
        p = optax.apply_updates(p, upd)
        elbos.append(float(value))
    got = TS.svgp_fit(TS.svgp_params_from_numpy(JS.svgp_init(
        jnp.asarray(x), jnp.asarray(mask), 16, jnp.asarray(X0), 0.15)),
        *(torch.tensor(a) for a in (x, y, mask)), idx, TS.SVGPConfig(
            num_inducing=16, iterations=50, batch_size=32, learning_rate=1e-2, elbo_log_every=5))
    for f in TS.SVGPParams._fields:
        np.testing.assert_allclose(getattr(got.params, f).numpy(), np.asarray(getattr(p, f)),
                                   rtol=0, atol=1e-8, err_msg=f)
    np.testing.assert_allclose(got.elbo_log.numpy(), elbos[::5], rtol=1e-9)
    moved = got.params.log_hypers.numpy() - X0
    assert np.abs(moved).max() > 0.1  # the steps really move the state


def test_predict_equal():
    jp = _params(8)
    xstar = np.array([[0.0, 0.0, 4.0], [1e5, -5e4, 2.0]])
    ref = JS.svgp_predict(jp, jnp.asarray(xstar))
    got = TS.svgp_predict(TS.svgp_params_from_numpy(jp), torch.tensor(xstar))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), rtol=1e-12)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(ref.std), rtol=1e-12)


def test_kl_zero_at_init_and_elbo_bounds_exact_lml():
    """tests/test_svgp.py's variational properties through the port."""
    x, y = _cell(77, 120)
    n = len(y)
    xt, yt, ones = torch.tensor(x), torch.tensor(y), torch.ones(n, dtype=torch.float64)
    p0 = TS.svgp_init(xt, ones, 24, torch.tensor(LOG_H), 0.15)
    assert abs(float(TS._kl(p0))) < 1e-10
    cfg = TS.SVGPConfig(num_inducing=24, iterations=300, batch_size=n)
    fit = TS.svgp_fit(p0, xt, yt, ones, torch.Generator().manual_seed(2), cfg)
    for params in (p0, fit.params):
        full = float(TS.elbo(params, xt, yt, ones, torch.tensor(float(n)), cfg.kind, cfg.jitter))
        lml = float(exact_gp.predict(params.log_hypers, xt, yt, torch.tensor([[0.0, 0.0, 4.0]]),
                                     ones, params.mean).lZ)
        assert np.isfinite(full) and full <= lml + 1e-6, (full, lml)


def test_approaches_exact_gp_at_its_hypers():
    """tests/test_svgp.py's comparison with the exact GP at the SVGP's own
    learned hyperparameters and mean (the sparse approximation's error
    alone), at that test's sizes, with the port's generator."""
    rng = np.random.default_rng(1234)
    log_h = np.log(np.array([4.0e5, 4.0e5, 6.0, 0.03, 0.004]))
    n = 200
    x = rng.uniform(-3e5, 3e5, size=(n, 3)) * np.asarray([1, 1, 1.2e-5])
    k = oracle.matern32_gram(x, np.exp(log_h[:3]), np.exp(log_h[3]))
    y = 0.15 + rng.multivariate_normal(np.zeros(n), k + np.exp(log_h[4]) * np.eye(n))
    xt, yt, ones = torch.tensor(x), torch.tensor(y), torch.ones(n, dtype=torch.float64)
    cfg = TS.SVGPConfig(num_inducing=50, iterations=2000, batch_size=64, learning_rate=1e-2)
    p0 = TS.svgp_init(xt, ones, 50, torch.tensor(X0), 0.15)
    fit = TS.svgp_fit(p0, xt, yt, ones, torch.Generator().manual_seed(0), cfg)
    el = fit.elbo_log.numpy()
    assert np.isfinite(el[-1]) and el[-1] > el[0] + 10
    xstar = torch.tensor([[0.0, 0.0, 4.0]])
    sp = TS.svgp_predict(fit.params, xstar)
    pe = exact_gp.predict(fit.params.log_hypers, xt, yt, xstar, ones, fit.params.mean)
    assert abs(float(sp.mean[0]) - float(pe.mean[0])) < 0.005
    assert abs(float(sp.std[0]) - float(pe.std[0])) < 0.005
    assert float(sp.std[0]) > 0


def test_mask_excludes_padding():
    x, y, mask = _padded(9)
    xt, yt, mt = (torch.tensor(a) for a in (x, y, mask))
    cfg = TS.SVGPConfig(num_inducing=16, iterations=200, batch_size=32)
    p0 = TS.svgp_init(xt, mt, 16, torch.tensor(X0), 0.15)
    fit = TS.svgp_fit(p0, xt, yt, mt, torch.Generator().manual_seed(1), cfg)
    sp = TS.svgp_predict(fit.params, torch.tensor([[0.0, 0.0, 4.0]]))
    assert abs(float(sp.mean[0])) < 1.0  # the poisoned padding (99) is never drawn
    assert np.isfinite(fit.params.z.numpy()).all()
    assert np.isfinite(fit.elbo_log.numpy()).all() and len(fit.elbo_log) == 20


@pytest.mark.parametrize("seed", [0, 1])
def test_generator_draws_valid_points_only(seed):
    x, y, mask = _padded(seed)
    xt, yt, mt = (torch.tensor(a) for a in (x, y, mask))
    cfg = TS.SVGPConfig(num_inducing=8, iterations=3, batch_size=64)
    g1, g2 = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
    a = TS.svgp_fit(TS.svgp_init(xt, mt, 8, torch.tensor(X0), 0.15), xt, yt, mt, g1, cfg)
    b = TS.svgp_fit(TS.svgp_init(xt, mt, 8, torch.tensor(X0), 0.15), xt, yt, mt, g2, cfg)
    for f in TS.SVGPParams._fields:  # one seed, one trajectory
        assert torch.equal(getattr(a.params, f), getattr(b.params, f))
    idx = torch.multinomial(mt / mt.sum(), 3 * 64, replacement=True,
                            generator=torch.Generator().manual_seed(seed))
    assert bool((mt[idx] == 1).all())
