"""The port's marginal likelihood and K3's plain twins against the JAX
package, float64 on the CPU.

The same seeded numpy inputs go through ``exact_gp.neg_log_marginal_likelihood``
of both packages, and through ``fused_gp.gp_nll_plain`` /
``gp_nll_and_grad_plain`` (the analytic form K3 computes) against
``jax.vmap(jax.value_and_grad(...))`` of the JAX objective, the oracle of
tests/test_pallas_gp.py, at its tolerances: value rtol 1e-11, gradient atol
1e-9 (the two sum N^2 terms in another order). One case runs the Pallas
kernel itself in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalinterpolation_tpu.models import exact_gp as JE
from optimalinterpolation_tpu.ops import pallas_gp
from optimalinterpolation_tpu_torch.models import exact_gp as TE
from optimalinterpolation_tpu_torch.ops import fused_gp
from optimalinterpolation_tpu_torch.ops.kernels import Kernel

N = 128


def _problem(seed, b=3, n=N, mask_p=0.85):
    """Inputs like tests/test_pallas_gp.py::_problem, hypers differing per row."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.1, 0.05, (b, n))
    mask = (rng.random((b, n)) < mask_p).astype(np.float64)
    h = np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]) + rng.normal(0.0, 0.3, (b, 5))
    return h, x, y, mask


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _jax_vg(kind, jitter=1e-6):
    return jax.vmap(jax.value_and_grad(
        lambda hh, xx, yy, mm: JE.neg_log_marginal_likelihood(
            hh, xx, yy, mm, kind=kind.value, jitter=jitter)))


@pytest.mark.parametrize("kind", list(Kernel))
def test_nll_and_analytic_twin_match_jax(kind):
    h, x, y, mask = _problem(1)
    ref_v, ref_g = _jax_vg(kind)(*map(jnp.asarray, (h, x, y, mask)))
    value = TE.neg_log_marginal_likelihood(*_t(h, x, y, mask), kind=kind, jitter=1e-6)
    np.testing.assert_allclose(value.numpy(), np.asarray(ref_v), rtol=1e-12)
    np.testing.assert_allclose(
        fused_gp.gp_nll_plain(*_t(h, x, y, mask), kind=kind, jitter=1e-6).numpy(),
        np.asarray(ref_v), rtol=1e-12)
    nll, grad = fused_gp.gp_nll_and_grad_plain(*_t(h, x, y, mask), kind=kind, jitter=1e-6)
    np.testing.assert_allclose(nll.numpy(), np.asarray(ref_v), rtol=1e-11)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_g), atol=1e-9)
    # on a CPU tensor the wrappers are their twins, and count no launch
    before = (fused_gp.gp_nll.launches, fused_gp.gp_nll_and_grad.launches)
    w_nll, w_grad = fused_gp.gp_nll_and_grad(*_t(h, x, y, mask), kind=kind, jitter=1e-6)
    assert torch.equal(w_nll, nll) and torch.equal(w_grad, grad)
    assert torch.equal(fused_gp.gp_nll(*_t(h, x, y, mask), kind=kind, jitter=1e-6), value)
    assert (fused_gp.gp_nll.launches, fused_gp.gp_nll_and_grad.launches) == before


@pytest.mark.parametrize("kind", list(Kernel))
def test_analytic_twin_matches_autograd(kind):
    """The folded-trace gradient against torch.autograd of the objective, at
    a size K3 does not take (N = 96) and with a jitter."""
    h, x, y, mask = _problem(2, b=4, n=96)
    hh = torch.tensor(h, requires_grad=True)
    value = TE.neg_log_marginal_likelihood(hh, *_t(x, y, mask), kind=kind, jitter=1e-4)
    (auto,) = torch.autograd.grad(value.sum(), hh)
    nll, grad = fused_gp.gp_nll_and_grad_plain(*_t(h, x, y, mask), kind=kind, jitter=1e-4)
    torch.testing.assert_close(nll, value.detach(), rtol=1e-12, atol=0)
    torch.testing.assert_close(grad, auto, rtol=0, atol=1e-10)


def test_twin_matches_pallas_kernel_in_interpret_mode():
    h, x, y, mask = _problem(3, b=3)
    p_nll, p_grad = pallas_gp.gp_nll_and_grad(
        *map(jnp.asarray, (h, x, y, mask)), kind=Kernel.MATERN32.value, jitter=1e-6,
        interpret=True)
    nll, grad = fused_gp.gp_nll_and_grad_plain(*_t(h, x, y, mask), jitter=1e-6)
    np.testing.assert_allclose(nll.numpy(), np.asarray(p_nll), rtol=1e-11)
    np.testing.assert_allclose(grad.numpy(), np.asarray(p_grad), atol=1e-9)


def test_padding_changes_nothing():
    h, x, y, mask = _problem(4, b=2, n=64, mask_p=1.0)
    small = fused_gp.gp_nll_and_grad_plain(*_t(h, x, y, mask), jitter=1e-6)
    rng = np.random.default_rng(0)
    pad = 64
    xp = np.concatenate([x, rng.uniform(-1e5, 1e5, (2, pad, 3))], axis=1)
    yp = np.concatenate([y, rng.normal(0, 1, (2, pad))], axis=1)
    mp = np.concatenate([mask, np.zeros((2, pad))], axis=1)
    big = fused_gp.gp_nll_and_grad_plain(*_t(h, xp, yp, mp), jitter=1e-6)
    torch.testing.assert_close(big[0], small[0], rtol=1e-12, atol=0)
    torch.testing.assert_close(big[1], small[1], rtol=0, atol=1e-10)
    torch.testing.assert_close(
        TE.neg_log_marginal_likelihood(*_t(h, xp, yp, mp), jitter=1e-6), small[0],
        rtol=1e-12, atol=0)


def test_all_padding_row_is_zero_and_nan_hypers_are_inf():
    h, x, y, mask = _problem(5, b=3)
    mask[0] = 0.0
    h[2] = np.nan
    nll, grad = fused_gp.gp_nll_and_grad_plain(*_t(h, x, y, mask), jitter=1e-6)
    assert nll[0] == 0 and bool((grad[0] == 0).all())  # A = I
    assert torch.isfinite(nll[1]) and bool(torch.isfinite(grad[1]).all())
    assert torch.isinf(nll[2]) and nll[2] > 0 and bool(torch.isnan(grad[2]).all())
    value = TE.neg_log_marginal_likelihood(*_t(h, x, y, mask), jitter=1e-6)
    assert value[0] == 0 and torch.isinf(value[2]) and value[2] > 0


def test_failed_cholesky_gives_inf_as_in_jax():
    """Coincident points without noise or jitter: not positive definite."""
    h, x, y, mask = _problem(6, b=2, n=32, mask_p=1.0)
    x[0, 1] = x[0, 0]
    x[0, 3] = x[0, 2]
    h[:, 4] = -80.0  # sn2 = e^-80
    ref = jax.vmap(lambda hh, xx, yy, mm: JE.neg_log_marginal_likelihood(hh, xx, yy, mm))(
        *map(jnp.asarray, (h, x, y, mask)))
    got = TE.neg_log_marginal_likelihood(*_t(h, x, y, mask))
    assert np.isinf(np.asarray(ref)[0]) and torch.isinf(got[0]) and got[0] > 0
    np.testing.assert_allclose(got[1].item(), float(ref[1]), rtol=1e-9)
    nll, grad = fused_gp.gp_nll_and_grad_plain(*_t(h, x, y, mask))
    assert torch.isinf(nll[0]) and bool(torch.isnan(grad[0]).all())


def test_leading_batch_shapes():
    h, x, y, mask = _problem(7, b=4, n=32)
    flat = TE.neg_log_marginal_likelihood(*_t(h, x, y, mask), jitter=1e-6)
    two = TE.neg_log_marginal_likelihood(
        *[a.reshape((2, 2) + a.shape[1:]) for a in _t(h, x, y, mask)], jitter=1e-6)
    assert two.shape == (2, 2)
    torch.testing.assert_close(two.reshape(4), flat, rtol=1e-13, atol=0)
    one = TE.neg_log_marginal_likelihood(*[a[0] for a in _t(h, x, y, mask)], jitter=1e-6)
    assert one.shape == () and abs(one.item() - flat[0].item()) <= 1e-12 * abs(flat[0].item())
