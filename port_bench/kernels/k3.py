"""K3, the fused marginal likelihood and its gradient (``ops/fused_gp.py``
-> ``csrc/k3_nll_grad.cu``), every objective of the fit at N <= 1024. A
launch of ``b`` cells of ``n`` points reads the hypers, points,
observations and mask once and writes the NLL (and the five-entry
gradient); the value needs the Cholesky, n^3 / 3 operations, the gradient
also L^-1 and the lower triangle of L^-T L^-1, n^3 in all (a multiply-add
is two), as ``chip_smoke.py`` counts them."""

NAME = "k3"
ENTRY = "oi_k3_nll"
TRACE_NAME = "k3_nll_kernel"  # both variants, value and gradient
PEAK_FLOPS = 495e12 / 3  # 3xTF32 at the H100 SXM's dense TF32 peak
PEAK_BYTES_PER_S = 3.35e12


def work(args) -> tuple:
    """``args``: log_hypers, x, y, mask, a_scr, u_scr, w_scr, nll, grad, b,
    n, kind, jitter, with_grad."""
    b, n, with_grad = int(args[9]), int(args[10]), bool(args[13])
    if with_grad:
        return b * float(n) ** 3, b * (5.0 * n + 11) * 4
    return b * float(n) ** 3 / 3.0, b * (5.0 * n + 6) * 4
