"""The port's BFGS (``models/bfgs.py::minimize_bfgs``) against
``jax.scipy.optimize.minimize(..., method="BFGS")``, float64 on the CPU.

The same function from the same start in both: a 5-d Rosenbrock (from
starts whose line searches take each branch: the Wolfe point found at
once, zooms, and a zoom that fails) and a tiny cell's Nystrom objective, as
the ``cell`` command minimizes it. Equal iterations, evaluations and
status; x within 1e-7 relative; the value within 1e-10 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.optimize import minimize as jax_minimize

from optimalinterpolation_tpu.models import nystroem as JN
from optimalinterpolation_tpu_torch.models import bfgs
from optimalinterpolation_tpu_torch.models import nystroem as TN

from . import oracle


def _same(ref, got):
    assert got.nit == int(ref.nit) and got.status == int(ref.status)
    assert got.nfev == int(ref.nfev) and got.njev == int(ref.njev)
    assert got.success == bool(ref.success)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-7,
                               atol=1e-7 * np.abs(np.asarray(ref.x)).max())
    np.testing.assert_allclose(float(got.fun), float(ref.fun), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(got.jac.numpy(), np.asarray(ref.jac), rtol=1e-5,
                               atol=1e-7 * max(1.0, np.abs(np.asarray(ref.jac)).max()))
    np.testing.assert_allclose(got.hess_inv.numpy(), np.asarray(ref.hess_inv), rtol=1e-6,
                               atol=1e-8 * np.abs(np.asarray(ref.hess_inv)).max())


@pytest.mark.parametrize("maxiter", [None, 15])
@pytest.mark.parametrize("x0", [(-1.2, 1.0, -0.5, 0.8, 1.3), (1.3, 0.7, 0.8, 1.9, 1.2),
                                (0.0, 0.0, 0.0, 0.0, 0.0)])
def test_rosenbrock_matches_jax(x0, maxiter):
    def rosen(x):
        return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()

    def rosen_j(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    opts = {} if maxiter is None else {"maxiter": maxiter}
    ref = jax_minimize(rosen_j, jnp.asarray(x0, jnp.float64), method="BFGS", options=opts)
    got = bfgs.minimize_bfgs(rosen, torch.tensor(x0, dtype=torch.float64), **opts)
    _same(ref, got)


def test_cell_nystroem_objective_matches_jax():
    rng = np.random.default_rng(3)
    n, pad = 70, 26
    x = rng.uniform(-3e5, 3e5, size=(n, 3)) * np.asarray([1, 1, 1.2e-5])
    k = oracle.matern32_gram(x, np.array([1.5e5, 1.2e5, 2.5]), 0.03)
    y = rng.multivariate_normal(np.zeros(n), k + 0.004 * np.eye(n))
    x = np.concatenate([x, np.zeros((pad, 3))])
    y = np.concatenate([y, np.zeros(pad)])
    mask = np.concatenate([np.ones(n), np.zeros(pad)])
    lm = np.sort(rng.choice(n, 32, replace=False))
    h0 = np.log(np.array([25e3, 25e3, 1.0, 1.0, 0.1]))

    def jf(h):
        return JN.nystroem_nll(h, jnp.asarray(x), jnp.asarray(y), jnp.asarray(lm),
                               jnp.asarray(mask), jitter=1e-6)

    def tf(h):
        return TN.nystroem_nll(h, *(torch.tensor(a) for a in (x, y, lm, mask)), jitter=1e-6)

    ref = jax_minimize(jf, jnp.asarray(h0), method="BFGS", options={"maxiter": 30})
    got = bfgs.minimize_bfgs(tf, torch.tensor(h0), maxiter=30)
    assert got.nit > 5  # it really iterates
    _same(ref, got)

