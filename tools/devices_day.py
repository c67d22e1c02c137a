#!/usr/bin/env python3
"""The fit phase's day of ``chip_smoke.py`` on one card and sharded over
several (``--devices``), on a machine with one or more NVIDIA cards.

Run from the root of the repository:

    python3 tools/devices_day.py

It runs ``chip_smoke.py``'s phases that phase 13 needs, with their own
checks: device, build, the quicklook day (slice) and the two-pass day on
one card (fit), then phase 13 itself (``chip_smoke.phase_devices``: two
shards on ``cuda:0``, the quicklook day on them, and with two or more cards
``daily --devices N`` over all N cards). Then, with two or more cards, the
day through ``daily --devices N`` for every N from 2 to the number of
cards. Each sharded day is held to
phase 13's gates against the one-card day (hyper fields bit-equal, every
other field within 1e-6 m, rmse within 1e-6 m). Last, one JSON line: the
card's name and power limit, and the day wall (host clock, ``cli.main``,
ending with the pickle written), fit wall, host syncs and peak memory on
card 0 for each number of cards run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        cs._fail("torch.cuda.is_available() is False")
    from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    t0 = time.perf_counter()
    cs.phase_device()
    cs.phase_build()
    n_cards = torch.cuda.device_count()
    days = {}
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_season(tmp, grid_res_km=cs.RES_KM, n_days=cs.N_DAYS, seed=7,
                              tracks_per_day=(10, 3, 8, 8), noise_std=0.1)
        day = cs._Day(tmp)
        quick = cs.phase_slice(tmp, day)
        fit = cs.phase_fit(tmp, day)
        days["1"] = {k: fit[k] for k in ("day_wall_s", "fit_wall_s", "host_syncs",
                                         "peak_mem_gb")}
        cs.phase_devices(tmp, day, quick, fit)
        for n in range(2, n_cards + 1):
            torch.cuda.reset_peak_memory_stats(0)
            res, date, _, syncs, wall, handler = cs._run_daily(tmp, ["--devices", str(n)])
            cs._gate_sharded(cs._compare_days(res, fit["result"], date), f"{n} cards", True)
            rmse = day.rmse(res[f"{date}_interp_smth"])
            if not abs(rmse - fit["rmse_vs_truth_m"]) <= cs.SHARD_TOL_M:
                cs._fail(f"{n} cards: rmse {rmse} against {fit['rmse_vs_truth_m']}")
            fit_s, _ = cs._fit_predict_walls(cs._stage_entries(handler.stages))
            days[str(n)] = {"day_wall_s": wall, "fit_wall_s": fit_s, "host_syncs": syncs,
                            "peak_mem_gb": torch.cuda.max_memory_allocated(0) / 1e9}
    print(json.dumps({"cards": smi, "cells": int(day.active.sum()),
                      "day_by_cards": days, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
