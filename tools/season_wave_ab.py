#!/usr/bin/env python3
"""Waves against the same days one by one, on one NVIDIA card.

Run from the root of the repository on a machine with one card:

    python3 tools/season_wave_ab.py [--rounds 1]

On ``chip_smoke.py``'s season (the synthetic 25 km season with
``bench.py``'s parameters, 12 days) at the fit settings of the ``daily``
command's defaults, each round runs two modes in turns (serial, waves,
waves, serial):

  serial  windows 0 and 2 by ``interpolate_daily``, cold; then windows 1 and
          3, each started from its predecessor's fitted hypers;
  waves   windows 0 and 2 as one wave by ``interpolate_days``, cold; then
          windows 1 and 3 as one wave, each started from its predecessor.

Prints one JSON line per mode and half (cold, chained): the card's name and
power limit, cells, wall (host clock, ending with the results on the host),
cells/s, launches of K1, K2, K3 value and K3 gradient, K3 value launches by
rows, host synchronisations, and the iteration sums and walls of the fit
stages. Then the largest difference between the two modes' fields of each
window (a wave shuffles subsample rows over the combined bucket, so the
seeded cold fields are not bit-equal).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("season_wave_ab: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke as cs
    from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season
    from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season
    from optimalinterpolation_tpu_torch.models import optimizer
    from optimalinterpolation_tpu_torch.models.optimizer import OptimizeConfig
    from optimalinterpolation_tpu_torch.ops import fused_gp
    from optimalinterpolation_tpu_torch.pipeline.daily import DailyConfig, interpolate_daily
    from optimalinterpolation_tpu_torch.pipeline.multiday import interpolate_days

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg = DailyConfig(opt=OptimizeConfig(ftol_abs=1e-3), jitter=1e-6)
    prior = cs.PRIOR

    def serial(ds, days, inits):
        return [interpolate_daily(ds, d, prior, cfg, init_hypers=i, stats=stats)
                for d, i in zip(days, inits)]

    def waves(ds, days, inits):
        return interpolate_days(ds, days, [prior] * len(days), cfg, stats=stats,
                                init_hypers=None if inits[0] is None else inits)

    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_season(tmp, grid_res_km=cs.RES_KM, n_days=cs.SEASON_DAYS, seed=7,
                              tracks_per_day=(10, 3, 8, 8), noise_std=0.1)
        ds = read_freeboard_season(tmp, cs.RES_KM, "2018-2019")
        fields = {}
        for _ in range(args.rounds):
            for mode, run in (("serial", serial), ("waves", waves), ("waves", waves),
                              ("serial", serial)):
                res = {}
                for half, days in (("cold", [0, 2]), ("chained", [1, 3])):
                    inits = ([None, None] if half == "cold"
                             else [res[d - 1].hypers for d in days])
                    stats = []
                    cs._zero_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = run(ds, days, inits)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    res.update(zip(days, out))
                    cells = sum(int(np.isfinite(r.interp).sum()) for r in out)
                    fit = [e for e in stats if "converged" in e]
                    print(json.dumps({
                        "mode": mode, "half": half, "windows": days, "card": smi,
                        "cells": cells, "wall_s": wall, "cells_per_s": cells / wall,
                        "launches": cs._counts(),
                        "k3_value_rows": cs._rows_histogram(),
                        "host_syncs": optimizer._lbfgs_segment.host_syncs,
                        "fit_iters_sum": sum(e["iters_sum"] for e in fit),
                        "fit_wall_s": sum(e["wall_s"] for e in fit),
                        "fine_n1024": {k: sum(e[k] for e in fit if e["stage"] == "opt"
                                              and e["n"] == 1024)
                                       for k in ("cells", "iters_sum", "wall_s")},
                        "k3_value_launches_a_cell": fused_gp.gp_nll.launches / cells,
                    }), flush=True)
                fields.setdefault(mode, res)
        for d in range(4):
            a, b = fields["serial"][d], fields["waves"][d]
            print(json.dumps({"window": d, "max_abs_d_interp_smth": float(
                np.nanmax(np.abs(a.interp_smth - b.interp_smth))),
                "same_nan_mask": bool(np.array_equal(np.isnan(a.interp_smth),
                                                     np.isnan(b.interp_smth)))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
