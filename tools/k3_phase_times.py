#!/usr/bin/env python3
"""Where one K3 cell's time goes, phase by phase, on the card.

Run from the root of the repository on a machine with one NVIDIA card:

    python3 tools/k3_phase_times.py

It copies ``optimalinterpolation_tpu_torch`` into a temporary directory,
adds ``%globaltimer`` stamps to that copy's K3 (a barrier, then thread 0 of
CTA 0 writes the time) at the phase boundaries, builds it, launches K3 at
N = 1024 (1 row and 132 rows, value and value + gradient, the inputs of
``tools/time_fused_kernels.py``) and prints one JSON line with the card's
name and power limit and, for each launch, the microseconds CTA 0 spent in:
the covariance build; the 8 diagonal 128x128 factors; the 28 panel and 84
trailing tile products of the Cholesky; the forward solve and the NLL; and,
with the gradient, the backward solve, step 4 (L^-T, 112 products) and
step 5 (Q's five sums, 120 products). The stamps add a barrier each; the
repository's own sources are not touched.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STAMP = """namespace oi {
__device__ unsigned long long g_stamps[64];
__device__ inline void stamp(int i) {
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[i] = t;
  }
}
"""

# (file, anchor, text placed before the anchor); stamp i marks a boundary:
# 0 start, 1 build done, 10 + 3 kb / 11 + 3 kb around diagonal factor kb,
# 12 + 3 kb after panel kb, 2 Cholesky done, 3 NLL done, 4 alpha done,
# 5 step 4 done, 6 step 5 done
PATCHES = [
    ("gp_common.cuh", "    factor_invert_128(sd, sw, ld, okk);\n", "    stamp(10 + 3 * kb);\n"),
    ("gp_common.cuh", "    if (thread_index() == 0) {\n      sums[0] += ld;",
     "    stamp(11 + 3 * kb);\n"),
    ("gp_common.cuh", "    // trailing row ib: A_ij -= L_ik L_jk^T", "    stamp(12 + 3 * kb);\n"),
    ("k3_nll_grad.cu", "  // ---- 1. scaled coordinates", "  oi::stamp(0);\n"),
    ("k3_nll_grad.cu", "  oi::blocked_cholesky(A, Wg, smem, n, logdet, ok);\n",
     "  oi::stamp(1);\n"),
    ("k3_nll_grad.cu", "  // ---- 2. z = L^-1 (y m)", "  oi::stamp(2);\n"),
    ("k3_nll_grad.cu", "  if (!kGrad) return;", "  oi::stamp(3);\n"),
    ("k3_nll_grad.cu", "  // ---- 4. U = L^-T", "  oi::stamp(4);\n"),
    ("k3_nll_grad.cu", "  // ---- 5. the five sums", "  oi::stamp(5);\n"),
    ("k3_nll_grad.cu", "  g0 = warp_sum(g0);", "  oi::stamp(6);\n"),
]


def _instrumented_copy(dst: str) -> None:
    pkg = os.path.join(dst, "optimalinterpolation_tpu_torch")
    shutil.copytree(os.path.join(ROOT, "optimalinterpolation_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(pkg, "csrc")
    path = os.path.join(csrc, "gp_common.cuh")
    src = open(path).read()
    src = src.replace("namespace oi {\n", STAMP, 1)
    open(path, "w").write(src)
    for name, anchor, text in PATCHES:
        path = os.path.join(csrc, name)
        src = open(path).read()
        if src.count(anchor) != 1:
            raise SystemExit(f"k3_phase_times: anchor not found once in {name}: {anchor!r}")
        open(path, "w").write(src.replace(anchor, text + anchor))
    path = os.path.join(csrc, "k3_nll_grad.cu")
    with open(path, "a") as f:
        f.write('\nextern "C" int oi_k3_stamps(unsigned long long* out) {\n'
                "  return static_cast<int>(\n"
                "      cudaMemcpyFromSymbol(out, oi::g_stamps, sizeof(oi::g_stamps)));\n}\n")


def _phases(t: list, n: int, grad: bool) -> dict:
    nb = n // 128
    us = lambda a, b: (t[b] - t[a]) / 1e3  # noqa: E731
    factor = sum(us(10 + 3 * k, 11 + 3 * k) for k in range(nb))
    panel = sum(us(11 + 3 * k, 12 + 3 * k) for k in range(nb - 1))
    trailing = sum(us(12 + 3 * k, 10 + 3 * (k + 1)) for k in range(nb - 1))
    out = {"build": us(0, 1), "diag_factors": factor, "panel_products": panel,
           "trailing_products": trailing, "cholesky": us(1, 2), "solve_nll": us(2, 3),
           "us_per_cholesky_product": (panel + trailing) / (nb * (nb - 1) * (nb + 1) / 6
                                                            + nb * (nb - 1) / 2)}
    if grad:
        out.update(alpha=us(3, 4), step4=us(4, 5), step5=us(5, 6),
                   us_per_step4_product=us(4, 5) / (nb * (nb - 1) * (nb + 1) / 6
                                                   + nb * (nb - 1) / 2),
                   us_per_step5_product=us(5, 6) / (nb * (nb + 1) * (nb + 2) / 6))
    out["total"] = us(0, 6 if grad else 3)
    return out


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        _instrumented_copy(tmp)
        sys.path.insert(0, tmp)
        from optimalinterpolation_tpu_torch.ops import _cuda, fused_gp
        from optimalinterpolation_tpu_torch.ops.kernels import Kernel
        from time_fused_kernels import _k3_args

        lib = _cuda.load()
        kw = dict(kind=Kernel.MATERN32, jitter=1e-6)
        rng = np.random.default_rng(0)
        report = {"card": smi}
        for b in (1, 132):
            args = _k3_args(rng, b, 1024)
            for grad in (False, True):
                fn = fused_gp.gp_nll_and_grad if grad else fused_gp.gp_nll
                for _ in range(2):  # the second launch is the one read
                    fn(*args, **kw)
                    torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 64)()
                if lib.oi_k3_stamps(buf) != 0:
                    raise SystemExit("k3_phase_times: reading the stamps failed")
                report[f"B={b} {'value+grad' if grad else 'value'}"] = _phases(
                    [int(v) for v in buf], 1024, grad)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
