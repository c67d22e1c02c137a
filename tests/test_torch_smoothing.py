"""The port's hyperparameter-field smoothing against the JAX package.

Both run the same normalized Gaussian convolution in float64 on the CPU on
seeded numpy fields; the results agree to 1e-12 (two convolution routines
summing the same taps in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalinterpolation_tpu.ops import smoothing as JS
from optimalinterpolation_tpu_torch.ops import smoothing as TS


def _field(seed, g=40):
    rng = np.random.default_rng(seed)
    f = np.abs(rng.normal(1.0, 0.4, (g, g)))
    f[rng.random((g, g)) < 0.2] = np.nan
    f[:12, :14] = np.nan  # a hole wider than the kernel: all-NaN neighbourhoods
    f[20, 20] = np.inf
    f[5, 30] = 50.0  # far above the clip
    sie = np.ones((g, g))
    sie[rng.random((g, g)) < 0.3] = np.nan
    sie[0, 0] = np.nan
    return f, sie


@pytest.mark.parametrize("std", [1.0, 2.0])
def test_smooth_hyper_field_matches_jax(std):
    f, sie = _field(int(std))
    ref = np.asarray(JS.smooth_hyper_field(jnp.asarray(f), 2.0, jnp.asarray(sie), std=std))
    got = TS.smooth_hyper_field(f, 2.0, sie, std=std)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(sie))  # the sie re-mask
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-12, rtol=0)


@pytest.mark.parametrize("std", [1.0, 2.0])
def test_kernel_and_nan_smooth_match_jax(std):
    np.testing.assert_allclose(
        TS.gaussian_kernel_2d(std).numpy(),
        np.asarray(JS.gaussian_kernel_2d(std, dtype=jnp.float64)), atol=1e-16, rtol=0)
    assert TS.gaussian_kernel_2d(std).shape == (2 * int(4 * std) + 1,) * 2
    f, _ = _field(7)
    f[np.isinf(f)] = np.nan
    ref = np.asarray(JS.nan_gaussian_smooth(jnp.asarray(f), std=std))
    got = TS.nan_gaussian_smooth(f, std=std).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)
    assert (got[:4, :4] == 0).all()  # no valid data under the kernel: exactly 0


def test_semantics_of_each_step():
    f, sie = _field(3)
    vmax = 2.0
    s = TS.smooth_hyper_field(torch.tensor(f), vmax, torch.tensor(sie), std=1.0).numpy()
    inside = np.isfinite(sie)
    assert np.isfinite(s[inside]).all() and (s[inside] <= vmax + 1e-12).all()  # clip, inf -> NaN
    # deep inside the hole every tap misses: the field mean stands in
    plain = TS.nan_gaussian_smooth(np.where(np.isinf(f) | (f > vmax), np.where(
        np.isinf(f), np.nan, vmax), f), std=1.0).numpy()
    assert plain[2, 2] == 0.0
    if inside[2, 2]:
        assert s[2, 2] == pytest.approx(plain.mean(), rel=1e-12)
    # float32 input is computed in float64 all the same
    s32 = TS.smooth_hyper_field(f.astype(np.float32), vmax, sie, std=1.0)
    assert s32.dtype == torch.float64
