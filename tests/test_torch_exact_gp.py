"""Port ``models/exact_gp.py`` and ``models/exact_gp_batch.py`` against JAX,
float64 on the CPU: the exact predict, and ``predict_batch``'s routing on N."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalinterpolation_tpu.models import exact_gp as JE
from optimalinterpolation_tpu.models.exact_gp_batch import _predict_batch_xla
from optimalinterpolation_tpu_torch.models import exact_gp as TE
from optimalinterpolation_tpu_torch.models import exact_gp_batch as TEB
from optimalinterpolation_tpu_torch.ops import blocked_gp, fused_gp


def _cell(seed, n=60, q=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3e5, 3e5, (n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.1, 0.05, n)
    mask = (rng.random(n) < 0.8).astype(np.float64)
    xs = rng.uniform(-1e5, 1e5, (q, 3)) * np.asarray([1, 1, 0]) + np.asarray([0.0, 0.0, 4.0])
    h = np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]) + rng.normal(0, 0.2, 5)
    return h, x, y, xs, mask


@pytest.mark.parametrize("kind", ["matern12", "matern32", "matern52", "se"])
@pytest.mark.parametrize("jitter", [0.0, 1e-6])
def test_predict_matches_jax(kind, jitter):
    h, x, y, xs, mask = _cell(0)
    ref = JE.predict(*map(jnp.asarray, (h, x, y, xs, mask)), 0.15, kind=JE.K.Kernel(kind),
                     jitter=jitter)
    got = TE.predict(*map(torch.from_numpy, (h, x, y, xs, mask)), 0.15,
                     kind=TE.K.Kernel(kind), jitter=jitter)
    for name in ("mean", "std", "prior_std"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-12, rtol=0, err_msg=name)
    np.testing.assert_allclose(float(got.lZ), float(ref.lZ), rtol=1e-12)
    assert bool(got.ok) and bool(ref.ok)


def test_nan_hypers_give_nan_cell_like_jax():
    h, x, y, xs, mask = _cell(1)
    h[3] = np.nan
    ref = JE.predict(*map(jnp.asarray, (h, x, y, xs, mask)), 0.15)
    got = TE.predict(*map(torch.from_numpy, (h, x, y, xs, mask)), 0.15)
    assert not bool(got.ok) and not bool(ref.ok)
    for name in ("mean", "std", "lZ", "prior_std"):
        assert np.isnan(getattr(got, name).numpy()).all(), name
        assert np.isnan(np.asarray(getattr(ref, name))).all(), name


@pytest.mark.parametrize("bad", ["indefinite", "nan"])
def test_masked_cholesky_flags_failure_like_jax(bad):
    from optimalinterpolation_tpu.ops import linalg as JL
    from optimalinterpolation_tpu_torch.ops import linalg as TL

    a = np.eye(3)
    if bad == "indefinite":
        a[0, 1] = a[1, 0] = 2.0
    else:
        a[2, 2] = np.nan
    assert not bool(TL.masked_cholesky(torch.from_numpy(a)).ok)
    assert not bool(JL.masked_cholesky(jnp.asarray(a)).ok)


def test_hyper_init_log_matches_jax():
    np.testing.assert_allclose(TE.HYPER_INIT_LOG(25e3, dtype=torch.float64).numpy(),
                               np.asarray(JE.HYPER_INIT_LOG(25e3, dtype=jnp.float64)), rtol=0)


def _batch(seed, b, n):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.1, 0.05, (b, n))
    mask = (rng.random((b, n)) < 0.85).astype(np.float64)
    h = np.tile(np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]), (b, 1)) + rng.normal(0, 0.1, (b, 5))
    xs = rng.uniform(-1e5, 1e5, (b, 3)) * np.asarray([1, 1, 0]) + np.asarray([0.0, 0.0, 4.0])
    return h, x, y, xs, mask, np.full((b,), 0.15)


@pytest.mark.parametrize("n, route", [(200, "plain"), (512, "fused"), (2048, "blocked")])
def test_predict_batch_routes_on_n(monkeypatch, n, route):
    """fused (K2) for N in [128, 1024], blocked (K1) for larger multiples of
    128, the plain predict otherwise: on the CPU as on the card."""
    called = []

    def spy(fn, tag):
        def wrapped(*a, **k):
            called.append(tag)
            return fn(*a, **k)
        return wrapped

    for mod, name, tag in ((fused_gp, "gp_predict", "fused"),
                           (blocked_gp, "gp_predict_blocked", "blocked"),
                           (fused_gp, "gp_predict_plain", "plain")):
        monkeypatch.setattr(mod, name, spy(getattr(mod, name), tag))
    args = _batch(n, b=1 if n == 2048 else 2, n=n)
    got = TEB.predict_batch(*map(torch.from_numpy, args), jitter=1e-6)
    assert called[0] == route
    ref = _predict_batch_xla(*map(jnp.asarray, args), jitter=1e-6)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), atol=1e-11, rtol=0)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(ref.std), atol=1e-11, rtol=0)
    np.testing.assert_allclose(got.lZ.numpy(), np.asarray(ref.lZ), rtol=1e-11, atol=0)
