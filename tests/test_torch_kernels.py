"""Port ``ops/kernels.py`` against the JAX package's, float64 on the CPU.

The same seeded numpy inputs go through both; the covariances agree to
rounding (rtol 1e-12), with and without a mask, per cell and batched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalinterpolation_tpu.ops import kernels as JK
from optimalinterpolation_tpu_torch.ops import kernels as TK

KINDS = ["matern12", "matern32", "matern52", "se"]


def _inputs(seed=0, b=3, n=40, m=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    xs = rng.uniform(-3e5, 3e5, (b, m, 3)) * np.asarray([1, 1, 1.2e-5])
    ell = np.exp(rng.normal(np.log([1.5e5, 2e5, 2.0]), 0.3, (b, 3)))
    sf2 = np.exp(rng.normal(np.log(0.03), 0.3, b))
    mask = (rng.random((b, n)) < 0.8).astype(np.float64)
    return x, xs, ell, sf2, mask


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matrix_matches_jax(kind, masked):
    x, _, ell, sf2, mask = _inputs()
    for i in range(x.shape[0]):
        mk = mask[i] if masked else None
        ref = JK.kernel_matrix(jnp.asarray(x[i]), jnp.asarray(ell[i]), sf2[i], kind=JK.Kernel(kind),
                               mask=None if mk is None else jnp.asarray(mk))
        got = TK.kernel_matrix(torch.from_numpy(x[i]), torch.from_numpy(ell[i]),
                               torch.tensor(sf2[i]), kind=TK.Kernel(kind),
                               mask=None if mk is None else torch.from_numpy(mk))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=0)
        np.testing.assert_array_equal(np.diag(got.numpy()), sf2[i] * (mk if masked else 1.0))


@pytest.mark.parametrize("kind", KINDS)
def test_cross_kernel_matches_jax(kind):
    x, xs, ell, sf2, mask = _inputs(seed=1)
    for i in range(x.shape[0]):
        ref = JK.cross_kernel(jnp.asarray(x[i]), jnp.asarray(xs[i]), jnp.asarray(ell[i]), sf2[i],
                              kind=JK.Kernel(kind), mask=jnp.asarray(mask[i]))
        got = TK.cross_kernel(torch.from_numpy(x[i]), torch.from_numpy(xs[i]),
                              torch.from_numpy(ell[i]), torch.tensor(sf2[i]),
                              kind=TK.Kernel(kind), mask=torch.from_numpy(mask[i]))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_batched_matches_vmapped_jax(kind):
    """The port's kernels take a leading batch axis where JAX vmaps."""
    x, xs, ell, sf2, mask = _inputs(seed=2)
    jkind = JK.Kernel(kind)
    ref_k = jax.vmap(lambda a, e, s, m: JK.kernel_matrix(a, e, s, kind=jkind, mask=m))(
        *map(jnp.asarray, (x, ell, sf2, mask)))
    ref_c = jax.vmap(lambda a, b, e, s, m: JK.cross_kernel(a, b, e, s, kind=jkind, mask=m))(
        *map(jnp.asarray, (x, xs, ell, sf2, mask)))
    t = [torch.from_numpy(a) for a in (x, xs, ell, sf2, mask)]
    got_k = TK.kernel_matrix(t[0], t[2], t[3], kind=TK.Kernel(kind), mask=t[4])
    got_c = TK.cross_kernel(t[0], t[1], t[2], t[3], kind=TK.Kernel(kind), mask=t[4])
    np.testing.assert_allclose(got_k.numpy(), np.asarray(ref_k), rtol=1e-12, atol=0)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=1e-12, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_shape_fn_matches_pallas(kind):
    """K2 evaluates pallas_gp._shape_fn's expressions; so does the port's."""
    from optimalinterpolation_tpu.ops import pallas_gp

    d2 = np.random.default_rng(3).uniform(0, 9, 257)
    d2[0] = 0.0
    ref = pallas_gp._shape_fn(JK.Kernel(kind), jnp.asarray(d2))
    got = TK._shape_fn(TK.Kernel(kind), torch.from_numpy(d2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_dlogell_weight_matches_jax_and_the_derivative(kind):
    """w(d2) against the JAX package's, zero distance included (the
    Matern-1/2 guard), and against autograd: d k / d log ell_d = sf2 w dq_d^2."""
    from optimalinterpolation_tpu.ops import pallas_gp

    rng = np.random.default_rng(3)
    d2 = np.abs(rng.normal(0.0, 2.0, (5, 9)))
    d2[0, 0] = 0.0
    ref = pallas_gp._dlogell_weight(JK.Kernel(kind), jnp.asarray(d2))
    got = TK._dlogell_weight(TK.Kernel(kind), torch.from_numpy(d2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13, atol=0)
    assert np.isfinite(got.numpy()).all()

    x, _, ell, sf2, _ = _inputs(seed=4, b=1, n=6)
    log_ell = torch.tensor(np.log(ell[0]), requires_grad=True)
    xt = torch.from_numpy(x[0])
    k = TK.kernel_matrix(xt, torch.exp(log_ell), torch.tensor(sf2[0]), kind=TK.Kernel(kind))
    xs = xt / torch.exp(log_ell.detach())
    dq2 = (xs[:, None, :] - xs[None, :, :]) ** 2
    w = TK._dlogell_weight(TK.Kernel(kind), dq2.sum(-1))
    for d in range(3):
        (dk,) = torch.autograd.grad(k[1:, 0].sum(), log_ell, retain_graph=True)
        expect = (sf2[0] * w * dq2[:, :, d])[1:, 0].sum()
        torch.testing.assert_close(dk[d], expect, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matrix_autograd_form_equals_the_in_place_form(kind):
    x, _, ell, sf2, mask = _inputs(seed=5)
    args = [torch.from_numpy(a) for a in (x, ell, sf2)]
    plain = TK.kernel_matrix(*args, kind=TK.Kernel(kind), mask=torch.from_numpy(mask))
    args[1].requires_grad_()
    diff = TK.kernel_matrix(*args, kind=TK.Kernel(kind), mask=torch.from_numpy(mask))
    assert diff.requires_grad and not plain.requires_grad
    torch.testing.assert_close(diff.detach(), plain, rtol=1e-14, atol=0)
    (g,) = torch.autograd.grad(diff.sum(), args[1])
    assert bool(torch.isfinite(g).all())  # sqrt's gradient at the zero diagonal is guarded
