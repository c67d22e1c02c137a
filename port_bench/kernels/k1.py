"""K1, the batched 128x128 factor and inverse (``ops/blocked_gp.py`` ->
``csrc/k1_factor_invert.cu``), under the blocked predict and the Nystrom
objectives. A launch of ``b`` blocks reads each block once and writes its
factor, its inverse, a log-determinant and a flag; it does the factor and
the inverse, 128^3 / 3 operations each (a multiply-add is two), as
``chip_smoke.py`` counts them."""

NAME = "k1"
ENTRY = "oi_k1_factor_invert"  # the C entry the program launches it through
TRACE_NAME = "k1_factor_invert_kernel"  # in the device kernel's name
# The fastest float32-accurate route of an H100 SXM: three TF32 products
# (3xTF32) at the published dense TF32 peak, and the HBM3 rate. Fixed
# whatever implements the kernel.
PEAK_FLOPS = 495e12 / 3
PEAK_BYTES_PER_S = 3.35e12
BLK = 128


def work(args) -> tuple:
    """(operations, bytes) of one launch; ``args`` as the entry takes them:
    d, l, w, logdet, ok, b."""
    b = int(args[5])
    return b * 2.0 * BLK ** 3 / 3.0, b * (3.0 * BLK * BLK * 4 + 5)
