"""K2, the fused per-cell predict (``ops/fused_gp.py`` ->
``csrc/k2_predict.cu``), at N <= 1024. A launch of ``b`` cells of ``n``
points reads the hypers, the points, the observations, the mask, the test
point and the prior mean once and writes five numbers a cell; it needs the
Cholesky of each cell's covariance, n^3 / 3 operations (a multiply-add is
two), as ``chip_smoke.py`` counts them."""

NAME = "k2"
ENTRY = "oi_k2_predict"
TRACE_NAME = "k2_predict_kernel"
PEAK_FLOPS = 495e12 / 3  # 3xTF32 at the H100 SXM's dense TF32 peak
PEAK_BYTES_PER_S = 3.35e12


def work(args) -> tuple:
    """``args``: log_hypers, x, y, xstar, mask, mean, a_scr, w_scr, out, b,
    n, kind, jitter."""
    b, n = int(args[9]), int(args[10])
    return b * float(n) ** 3 / 3.0, b * (5.0 * n + 14) * 4
