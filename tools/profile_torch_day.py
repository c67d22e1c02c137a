#!/usr/bin/env python3
"""Device profile of one full two-pass day of the PyTorch/CUDA port.

Run from the root of the repository on a machine with one NVIDIA card:

    python3 tools/profile_torch_day.py [--quicklook]

It writes ``chip_smoke.py``'s synthetic 25 km season (seed 7, tracks
(10, 3, 8, 8), noise 0.1), runs ``interpolate_daily`` once unprofiled (which
also builds the kernels) and once under ``torch.profiler``, and prints one
JSON line: the card's name and power limit, both walls, the device time summed
over all kernels, the device's busy and idle share of the profiled wall, and
the device time by group of kernels (K1, K2, K3 value, K3 gradient, library
matrix products, everything else). ``--quicklook`` profiles the predict-only
day with ``chip_smoke.py``'s constant hypers instead.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season  # noqa: E402
from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season  # noqa: E402
from optimalinterpolation_tpu_torch.models.optimizer import OptimizeConfig  # noqa: E402
from optimalinterpolation_tpu_torch.pipeline.daily import (  # noqa: E402
    DailyConfig,
    interpolate_daily,
)

GROUPS = ("K3 gradient", "K3 value", "K2", "K1", "library matrix products",
          "other device kernels")


def _group(kernel: str) -> str:
    """The group of a (mangled or demangled) kernel name."""
    if "k3_nll_kernel" in kernel:
        grad = any(t in kernel for t in ("<true>", "<(bool)1>", "ILb1"))
        return "K3 gradient" if grad else "K3 value"
    if "k2_predict_kernel" in kernel:
        return "K2"
    if "k1_factor_invert_kernel" in kernel:
        return "K1"
    if "gemm" in kernel.lower():
        return "library matrix products"
    return "other device kernels"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quicklook", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_season(tmp, grid_res_km=25, n_days=9, seed=7,
                              tracks_per_day=(10, 3, 8, 8), noise_std=0.1)
        ds = read_freeboard_season(tmp, 25, "2018-2019")
    # the CLI's defaults
    cfg = DailyConfig(jitter=1e-6, opt=OptimizeConfig(max_iters=60, ftol_abs=1e-3))
    hypers = None
    if args.quicklook:
        g = ds.x.shape[0]
        hypers = {k: np.full((g, g), v) for k, v in dict(
            ell_x=2e5, ell_y=2e5, ell_t=2.0, sf2=0.03, sn2=0.005).items()}

    def day():
        t0 = time.perf_counter()
        res = interpolate_daily(ds, 0, 0.15, cfg, precomputed_hypers=hypers)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    _, plain_s = day()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        res, profiled_s = day()
    by_group = {name: 0.0 for name in GROUPS}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us:
            by_group[_group(ev.key)] += us / 1e6
    device_s = sum(by_group.values())
    print(json.dumps({
        "card": smi, "day": "quicklook" if args.quicklook else "two-pass",
        "active_cells": int(np.isfinite(res.interp_smth).sum()),
        "wall_s": plain_s, "profiled_wall_s": profiled_s, "device_s": device_s,
        "device_busy_share": device_s / profiled_s,
        "device_idle_share": 1.0 - device_s / profiled_s,
        "device_s_by_group": by_group,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
