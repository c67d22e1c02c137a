"""Port ``ops/fused_gp.py`` (K2's wrapper and plain twin) against JAX, float64.

On the CPU the wrapper runs K2's plain twin; here it is held against the
Pallas kernel itself in interpret mode (as tests/test_pallas_gp.py runs it)
and against the vmapped XLA predict. K2 is held against the twin on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalinterpolation_tpu.models.exact_gp_batch import _predict_batch_xla
from optimalinterpolation_tpu.ops import pallas_gp
from optimalinterpolation_tpu_torch.ops import fused_gp


def _pallas_problem():
    """tests/test_pallas_gp.py::test_fused_predict_matches_xla's inputs."""
    rng = np.random.default_rng(1234)
    b, n = 3, 128
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.1, 0.05, (b, n))
    mask = (rng.random((b, n)) < 0.85).astype(np.float64)
    h = np.tile(np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]), (b, 1))
    h[1] += 0.3
    xs = (np.random.default_rng(5).uniform(-1e5, 1e5, (3, 3)) * np.asarray([1, 1, 0])
          + np.asarray([0.0, 0.0, 4.0]))
    return h, x, y, xs, mask, np.full((3,), 0.15)


def _problem(seed, b, n):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.1, 0.05, (b, n))
    mask = (rng.random((b, n)) < 0.85).astype(np.float64)
    h = np.tile(np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]), (b, 1))
    h[0] -= 0.2
    xs = rng.uniform(-1e5, 1e5, (b, 3)) * np.asarray([1, 1, 0]) + np.asarray([0.0, 0.0, 4.0])
    return h, x, y, xs, mask, rng.normal(0.15, 0.02, b)


def test_twin_matches_pallas_interpret():
    args = _pallas_problem()
    m_, s_, lz_, ps_, ok_ = pallas_gp.gp_predict(*map(jnp.asarray, args), jitter=1e-6,
                                                 interpret=True)
    got = fused_gp.gp_predict(*map(torch.from_numpy, args), jitter=1e-6)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(m_), atol=1e-12, rtol=0)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(s_), atol=1e-12, rtol=0)
    np.testing.assert_allclose(got.lZ.numpy(), np.asarray(lz_), rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.prior_std.numpy(), np.asarray(ps_), rtol=1e-15, atol=0)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ok_))


@pytest.mark.parametrize("kind", ["matern12", "matern52"])
def test_twin_matches_xla_at_512(kind):
    args = _problem(0, b=2, n=512)
    ref = _predict_batch_xla(*map(jnp.asarray, args), kind=pallas_gp.Kernel(kind), jitter=1e-6)
    got = fused_gp.gp_predict(*map(torch.from_numpy, args), kind=fused_gp.Kernel(kind),
                              jitter=1e-6)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), atol=1e-12, rtol=0)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(ref.std), atol=1e-12, rtol=0)
    np.testing.assert_allclose(got.lZ.numpy(), np.asarray(ref.lZ), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))


def test_nan_hypers_give_nan_cell_in_both():
    h, x, y, xs, mask, mean = _problem(1, b=3, n=256)
    h[2] = np.nan
    args = (h, x, y, xs, mask, mean)
    ref = _predict_batch_xla(*map(jnp.asarray, args), jitter=1e-6)
    got = fused_gp.gp_predict(*map(torch.from_numpy, args), jitter=1e-6)
    assert got.ok.tolist() == [True, True, False] == np.asarray(ref.ok).tolist()
    for g, r in ((got.mean, ref.mean), (got.std, ref.std), (got.lZ, ref.lZ)):
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(np.asarray(r)))
        assert np.isnan(g.numpy()[2])


def test_cpu_call_leaves_launches_at_zero():
    args = _problem(2, b=2, n=128)
    before = fused_gp.gp_predict.launches
    got = fused_gp.gp_predict(*map(torch.from_numpy, args))
    assert fused_gp.gp_predict.launches == before == 0
    twin = fused_gp.gp_predict_plain(*map(torch.from_numpy, args))
    for a, b in zip(got, twin):
        assert torch.equal(a, b)


def test_non_cpu_tensor_never_reaches_twin():
    """A tensor off the CPU goes to K2 or raises (here: meta tensors)."""
    args = [torch.empty(s, device="meta")
            for s in ((2, 5), (2, 128, 3), (2, 128), (2, 3), (2, 128), (2,))]
    with pytest.raises(ValueError, match="CUDA"):
        fused_gp.gp_predict(*args)


@pytest.mark.parametrize("n, ok", [(128, True), (512, True), (1024, True), (1152, False),
                                   (2048, False), (200, False), (64, False)])
def test_supported_matches_pallas(n, ok):
    assert fused_gp.supported(n) is ok is pallas_gp.supported(n)
