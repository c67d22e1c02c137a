"""The kernels' work counts against a hand count at N = 128, and their
argument order against the port's launch entries."""

import portbench_tiny  # noqa: F401
import pytest

from port_bench.core.spec import ROOT, load_module

K = {name: load_module(ROOT / "port_bench" / "kernels" / f"{name}.py")
     for name in ("k1", "k2", "k3")}


def test_k1_hand_count():
    # one 128x128 block: factor and inverse, 128^3 / 3 operations each;
    # D read, L and W written (3 x 65,536 bytes), a float and a flag
    assert K["k1"].work((None,) * 5 + (1,)) == pytest.approx((1_398_101.3333, 196_613))
    assert K["k1"].work((None,) * 5 + (352,))[0] == pytest.approx(352 * 1_398_101.3333)


def test_k2_hand_count():
    # hypers 5, x 384, y 128, x* 3, mask 128, mean 1 read; 5 written: 654 floats
    args = (None,) * 9 + (1, 128, 1, 1e-6)
    assert K["k2"].work(args) == pytest.approx((699_050.6667, 2_616))


def test_k3_hand_count():
    # the gradient: Cholesky, L^-1 and the lower triangle of L^-T L^-1,
    # 128^3 in all; hypers 5, x 384, y 128, mask 128 read, NLL and 5 written
    grad = (None,) * 9 + (1, 128, 1, 1e-6, 1)
    value = (None,) * 9 + (1, 128, 1, 1e-6, 0)
    assert K["k3"].work(grad) == pytest.approx((2_097_152, 2_604))
    assert K["k3"].work(value) == pytest.approx((699_050.6667, 2_584))


@pytest.mark.parametrize("name", ["k1", "k2", "k3"])
def test_entry_and_peak(name):
    from optimalinterpolation_tpu_torch.ops import _cuda

    k = K[name]
    assert k.ENTRY in _cuda._ENTRIES
    assert k.PEAK_FLOPS == pytest.approx(165e12)
    assert k.PEAK_BYTES_PER_S == pytest.approx(3.35e12)
