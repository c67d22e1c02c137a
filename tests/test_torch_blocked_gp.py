"""Port ``ops/blocked_gp.py`` (objective, predict, K1's wrapper) against JAX, float64.

On the CPU the K1 wrapper runs its plain twin, which mirrors the JAX
package's off-TPU reference ``_factor_invert_xla``; K1 itself is held against
the twin on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalinterpolation_tpu.models.exact_gp_batch import _predict_batch_xla
from optimalinterpolation_tpu.ops import blocked_gp as JB
from optimalinterpolation_tpu_torch.ops import blocked_gp as TB


def _problem(seed, b, n, mask_p=0.85):
    """tests/test_pallas_gp.py::_problem's distribution, plus test points."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.1, 0.05, (b, n))
    mask = (rng.random((b, n)) < mask_p).astype(np.float64)
    h = np.tile(np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]), (b, 1))
    h[1 % b] += 0.3
    xs = rng.uniform(-1e5, 1e5, (b, 3)) * np.asarray([1, 1, 0]) + np.asarray([0.0, 0.0, 4.0])
    mean = np.full((b,), 0.15)
    return h, x, y, xs, mask, mean


def _blocks(seed=0, b=16):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b + 1, 128, 128))
    d = g @ g.transpose(0, 2, 1) / 128 + 0.5 * np.eye(128)
    d[-1] -= 3.0 * np.eye(128)  # not positive definite
    return d


def test_factor_invert_plain_matches_xla():
    d = _blocks()
    lj, wj, ldj, okj = JB._factor_invert_xla(jnp.asarray(d))
    lt, wt, ldt, okt = TB._factor_invert_plain(torch.from_numpy(d))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt[:-1].all() and not okt[-1]
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-10, rtol=0)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-10, rtol=0)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=1e-12, atol=0)


def test_cpu_call_runs_twin_not_k1():
    d = torch.from_numpy(_blocks(b=2))
    before = TB._factor_invert.launches
    got = TB._factor_invert(d)
    assert TB._factor_invert.launches == before
    for a, b in zip(got, TB._factor_invert_plain(d)):
        assert torch.equal(a, b)


def test_non_cpu_tensor_never_reaches_twin():
    """A tensor off the CPU goes to K1 or raises (here: a meta tensor)."""
    with pytest.raises(ValueError, match="CUDA"):
        TB._factor_invert(torch.empty((2, 128, 128), device="meta"))


def test_blocks_round_trip():
    a = torch.arange(2 * 512 * 512, dtype=torch.float64).reshape(2, 512, 512)
    t = TB._to_blocks(a, 128)
    assert t.shape == (2, 4, 4, 128, 128)
    assert torch.equal(t[1, 2, 3], a[1, 256:384, 384:512])
    assert torch.equal(TB._unblock(t), a)


@pytest.mark.parametrize("kind", ["matern32", "se"])
def test_gp_predict_blocked_matches_jax(kind):
    """n = 384: three 128 blocks, the left-looking history contractions."""
    args = _problem(0, b=2, n=384)
    ref = JB.gp_predict_blocked(*map(jnp.asarray, args), kind=JB.Kernel(kind), jitter=1e-6)
    got = TB.gp_predict_blocked(*map(torch.from_numpy, args), kind=TB.Kernel(kind), jitter=1e-6)
    for name, r, g in zip(("mean", "std", "lZ", "prior_std"), ref[:4], got[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-12, rtol=1e-15, err_msg=name)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref[4]))


def test_gp_predict_blocked_panel_route_matches_xla():
    """n = 2048 factors in 512-wide panels whose diagonals recurse onto 128."""
    args = _problem(1, b=1, n=2048)
    assert TB._panel_size(2048) == TB.PANEL
    ref = _predict_batch_xla(*map(jnp.asarray, args), jitter=1e-6)
    got = TB.gp_predict_blocked(*map(torch.from_numpy, args), jitter=1e-6)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), atol=1e-11, rtol=0)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(ref.std), atol=1e-11, rtol=0)
    np.testing.assert_allclose(got.lZ.numpy(), np.asarray(ref.lZ), rtol=1e-11, atol=0)
    assert got.ok.all()


def test_nan_hypers_give_nan_cell():
    h, x, y, xs, mask, mean = _problem(2, b=2, n=256)
    h[1] = np.nan
    got = TB.gp_predict_blocked(*map(torch.from_numpy, (h, x, y, xs, mask, mean)), jitter=1e-6)
    assert got.ok.tolist() == [True, False]
    assert torch.isnan(torch.stack([got.mean[1], got.std[1], got.lZ[1]])).all()
    assert torch.isfinite(torch.stack([got.mean[0], got.std[0], got.lZ[0]])).all()


@pytest.mark.parametrize("n, rtol, atol", [(384, 1e-12, 1e-10), (2048, 1e-11, 1e-9)],
                         ids=["n384_3_blocks", "n2048_512_panels"])
def test_gp_nll_and_grad_blocked_matches_jax(n, rtol, atol):
    """Value, analytic gradient and the factor-reuse split against JAX's
    ``gp_nll_and_grad_blocked`` (tests/test_pallas_gp.py's tolerances): three
    128 blocks, and 512-wide panels whose T is re-blocked at 128."""
    h, x, y, _, mask, _ = _problem(3, b=2 if n < 1024 else 1, n=n)
    args_j, args_t = map(jnp.asarray, (h, x, y, mask)), list(map(torch.from_numpy, (h, x, y, mask)))
    jv, jg = JB.gp_nll_and_grad_blocked(*args_j, jitter=1e-6)
    tv, tg = TB.gp_nll_and_grad_blocked(*args_t, jitter=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=rtol, atol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=atol, rtol=0)
    assert torch.equal(TB.gp_nll_blocked(*args_t, jitter=1e-6), tv)
    nf, factors = TB.gp_nll_blocked_with_factors(*args_t, jitter=1e-6)
    assert torch.equal(nf, tv)
    assert torch.equal(TB.gp_grad_blocked_from_factors(*args_t, factors, jitter=1e-6), tg)


def test_gp_nll_blocked_failed_factor_is_inf_and_nan():
    h, x, y, _, mask, _ = _problem(4, b=2, n=256)
    h[0] = np.nan
    v, g = TB.gp_nll_and_grad_blocked(*map(torch.from_numpy, (h, x, y, mask)), jitter=1e-6)
    assert torch.isinf(v[0]) and v[0] > 0 and torch.isnan(g[0]).all()
    assert torch.isfinite(v[1]) and torch.isfinite(g[1]).all()


@pytest.mark.parametrize("kind", ["matern12", "matern52", "se"])
def test_gp_grad_blocked_other_kernels_match_jax(kind):
    h, x, y, _, mask, _ = _problem(5, b=2, n=256)
    jv, jg = JB.gp_nll_and_grad_blocked(*map(jnp.asarray, (h, x, y, mask)),
                                        kind=JB.Kernel(kind), jitter=1e-6)
    tv, tg = TB.gp_nll_and_grad_blocked(*map(torch.from_numpy, (h, x, y, mask)),
                                        kind=TB.Kernel(kind), jitter=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-10, rtol=0)
