"""``bench.py``'s day, rebuilt with the port's own modules: the North star's guard.

``bench.py`` imports the JAX package, so the port cannot call it; this
module copies what its day is made of. The 16-day synthetic season
(``bench.py:132-146``), the subsample (``bench.py:393-400``), the config
(``bench.py:404-410``), day 0 at prior 0.15 (``bench.py:476-478``) and the
score (``bench.py:446-452``), beside the rmse that the JAX package recorded
for the calibration and the full-scale day (DESIGN.md, "Round-5 end-to-end
numbers"; rounded to 0.1 mm by ``bench.py:493``) and the guard on it.

``chip_smoke.py`` (phase ``northstar``) runs the calibration day and
``tools/north_star_day.py`` the full-scale day, each under both routings;
``tests/test_torch_env_knobs.py`` holds the subsample and the score against
``bench.py``'s formulas. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np

GRID_RES_KM = 25
DAYS = 16  # bench.py:62-70: 16 synthetic days, 8 valid 9-day windows
PRIOR = 0.15  # bench.py:476-478, day 0
# the calibration day (scale 0.12, subsample seed 1) and the full-scale day
RECORDED = {"calibration": {"scale": 0.12, "seed": 1, "cells": 2086, "rmse_m": 0.0120},
            "full": {"scale": 1.0, "seed": 2, "cells": 17149, "rmse_m": 0.0116}}
# the guard, 0.5 mm, plus the 0.05 mm rounding of the record
TOL_M = 5.5e-4
# the JAX package's default routing (optimizer.py:93, :175) and the port's
ROUTINGS = {"jax": {"OI_BLOCKED_MIN_N": "512", "OI_NYSTROEM_MIN_N": "1024"}, "port": {}}
# the objectives of the JAX routing's fits by N: (backend, Nystrom rank)
JAX_OBJECTIVES = {512: ("blocked", None), 1024: ("nystroem", 512)}


@contextlib.contextmanager
def environ(knobs: dict):
    """The environment variables ``knobs`` set for the block, as a user's
    A/B harness sets them after import; each is restored (or removed) after."""
    before = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bench_season(tmp: str):
    """``bench.py``'s synthetic season in ``tmp``: the dataset and the FYI file."""
    from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season
    from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season

    make_synthetic_season(tmp, grid_res_km=GRID_RES_KM, n_days=DAYS, seed=7,
                          tracks_per_day=(10, 3, 8, 8), noise_std=0.1)
    fyi = np.load(os.path.join(tmp, f"CS2_FYI_synthetic_{GRID_RES_KM}km.npy"))
    return read_freeboard_season(tmp, GRID_RES_KM, "2018-2019"), fyi


def subsample(sie: np.ndarray, scale: float, seed: int) -> np.ndarray:
    """Below scale 1 the cells where ``default_rng(seed).random(sie.shape[:2])
    > scale`` become NaN (a copy)."""
    sie = sie.copy()
    if scale < 1.0:
        sie[np.random.default_rng(seed).random(sie.shape[:2]) > scale] = np.nan
    return sie


def score(field: np.ndarray, fyi: np.ndarray, t_mid: int) -> tuple:
    """(cells, rmse) over the finite cells of ``field`` against the truth,
    the FYI file + 0.02 m at ``t_mid``."""
    truth = fyi[:, :, t_mid] + 0.02
    scored = np.isfinite(field)
    return int(scored.sum()), float(np.sqrt(np.mean((field[scored] - truth[scored]) ** 2)))


def config():
    """``bench.py``'s ``DailyConfig``."""
    from optimalinterpolation_tpu_torch.models.optimizer import OptimizeConfig
    from optimalinterpolation_tpu_torch.pipeline.daily import DailyConfig

    return DailyConfig(window_days=9, radius_km=300.0, dtype="float32", jitter=1e-6,
                       opt=OptimizeConfig(max_iters=50, grad_tol=1e-3, ftol_abs=1e-3))


def run_day(ds, fyi, which: str, routing: str, device: str = "cuda") -> tuple:
    """Day ``which`` of ``RECORDED`` through ``interpolate_daily`` with the
    knobs of ``ROUTINGS[routing]`` set. Returns its summary (cells, wall,
    rmse against the record, the fitting stages, the keys not finite at
    every active cell) and the stage entries. Raises before the run when
    the subsample does not leave the recorded cells active."""
    import torch

    from optimalinterpolation_tpu_torch.pipeline.daily import interpolate_daily

    rec = RECORDED[which]
    cfg = config()
    sub = dataclasses.replace(ds, sie=subsample(ds.sie, rec["scale"], rec["seed"]))
    active = np.isfinite(sub.sie[:, :, cfg.t_mid])
    if int(active.sum()) != rec["cells"]:
        raise RuntimeError(f"north star {which}: {int(active.sum())} active cells, not "
                           f"bench.py's {rec['cells']}")
    stats = []
    with environ(ROUTINGS[routing]):
        t0 = time.perf_counter()
        res = interpolate_daily(sub, 0, PRIOR, cfg, stats=stats, device=device)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    d = res.to_reference_dict()
    cells, rmse = score(res.interp_smth, fyi, cfg.t_mid)
    fits = [{k: e[k] for k in ("stage", "n", "cells", "wall_s", "iters_sum", "backend", "m")
             if k in e} for e in stats if e["stage"].endswith(("cascade", "opt"))]
    out = {"day": which, "routing": routing, "knobs": ROUTINGS[routing], "cells": cells,
           "wall_s": wall, "cells_per_s": cells / wall, "rmse_vs_truth_m": rmse,
           "recorded_rmse_m": rec["rmse_m"], "d_rmse_m": rmse - rec["rmse_m"],
           "keys": len(d),
           "not_finite": [k for k, f in d.items() if not np.isfinite(f[active]).all()],
           "fits": fits}
    return out, stats


def failures(out: dict) -> list:
    """The guard's gates that ``run_day``'s summary fails: 15 keys, every
    active cell finite, the recorded cells scored, the JAX routing's fits on
    the JAX package's objectives, and rmse within ``TOL_M`` of the record
    under the JAX routing, at most the record + ``TOL_M`` under the port's
    (the exact objective may do better than Nystrom; better is no fault)."""
    which, routing, rmse = out["day"], out["routing"], out["rmse_vs_truth_m"]
    rec = RECORDED[which]
    what = f"north star {which}, {routing} routing"
    bad = []
    if out["keys"] != 15:
        bad.append(f"{what}: {out['keys']} keys, not 15")
    if out["not_finite"]:
        bad.append(f"{what}: {out['not_finite']} not finite at every active cell")
    if out["cells"] != rec["cells"]:
        bad.append(f"{what}: {out['cells']} scored cells, not {rec['cells']}")
    if routing == "jax":
        wrong = [e for e in out["fits"] if e["n"] in JAX_OBJECTIVES
                 and (e["backend"], e.get("m")) != JAX_OBJECTIVES[e["n"]]]
        if wrong:
            bad.append(f"{what}: stages off the JAX package's routing: {wrong}")
        if not abs(rmse - rec["rmse_m"]) <= TOL_M:
            bad.append(f"{what}: rmse {rmse!r} m is more than {TOL_M} m from the JAX "
                       f"package's {rec['rmse_m']} m")
    elif not rmse <= rec["rmse_m"] + TOL_M:
        bad.append(f"{what}: rmse {rmse!r} m above the JAX package's {rec['rmse_m']} m "
                   f"+ {TOL_M} m")
    return bad
