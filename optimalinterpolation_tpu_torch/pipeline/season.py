"""Season-scale production: many daily fields and reference-format outputs.

PyTorch counterpart of ``optimalinterpolation_tpu/pipeline/season.py``. The
reference produces one day per ``mpirun`` job and pickles a result dict per
day (``GPR_CS2S3.py:336``). A season run here goes over every valid window
(or the given ones), writes the same per-day pickle schema and the quicklook
NetCDFs, and resumes from the days already written. Each day's fitted
hypers start the next day's fit (chaining); the days run in strided waves
of up to ``day_parallel`` days (``pipeline.multiday``), one day a wave by
default.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
import warnings
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from optimalinterpolation_tpu_torch.data.prior import constant_fyi_prior
from optimalinterpolation_tpu_torch.data.reader import ObsDataset
from optimalinterpolation_tpu_torch.io.pickles import load_pickle, save_pickle
from optimalinterpolation_tpu_torch.io.quicklook import grid_lonlat, write_result_quicklook
from optimalinterpolation_tpu_torch.pipeline.daily import (
    HYPER_NAMES,
    DailyConfig,
    DailyResult,
)
from optimalinterpolation_tpu_torch.pipeline.multiday import interpolate_days

__all__ = ["SeasonConfig", "run_season", "seasonal_average_hypers"]


def seasonal_average_hypers(results: Sequence[DailyResult]) -> dict:
    """Per-cell seasonal-average hyperparameter fields (quicklook scheme).

    The reference's quicklook production reuses seasonal-average hypers from
    50 km runs regridded to 25 km instead of fitting
    (``QuickLook Data/README.txt:1``); this averages the smoothed fields of
    a set of daily results."""
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN cells
        for name in HYPER_NAMES:
            out[name] = np.nanmean(np.stack([r.hypers_smth[name] for r in results]), axis=0)
    return out


@dataclasses.dataclass(frozen=True)
class SeasonConfig:
    """Season knobs; defaults as in the JAX package's ``SeasonConfig``."""

    daily: DailyConfig = dataclasses.field(default_factory=DailyConfig)
    outdir: str = "."
    write_pickles: bool = True
    write_quicklook: bool = True
    resume: bool = True  # skip days whose pickle exists
    # Each day's fitted per-cell hypers start the next day's fit
    # (interpolate_days' init_hypers): consecutive windows share T-1 days,
    # so chained cells converge in a few iterations. Off: every day starts
    # cold and its result does not depend on which days ran before.
    chain_warmstart: bool = True
    # Strided waves of up to this many days (pipeline.multiday): wave j is
    # positions [j::n_waves] of the day list, so every day of wave j >= 1
    # starts from its predecessor, fitted in wave j - 1, and wave 0 starts
    # cold with spatial seeding. 0 or 1: waves of one day, a day at a time.
    day_parallel: int = 1


def _pickle_path(cfg: SeasonConfig, ds: ObsDataset, date: str) -> str:
    return os.path.join(cfg.outdir, f"CS2S3_{date}_{ds.grid_res_km}km.pkl")


def _resumed_chain(path: str, date: str) -> Optional[dict]:
    """The per-cell hyper fields of an already written day, to keep the
    chain alive across resumed days; None if the pickle cannot give them."""
    try:
        prev = load_pickle(path)
        return {n: prev[f"{date}_{n}"] for n in HYPER_NAMES}
    except (OSError, EOFError, KeyError, pickle.UnpicklingError):
        return None


def _prior_for(day: int, prior_fn, fyi) -> float:
    if prior_fn is not None:
        return prior_fn(day)
    if fyi is not None:
        return constant_fyi_prior(fyi, day)
    raise ValueError("provide prior_fn or fyi")


def _write(res: DailyResult, cfg: SeasonConfig, ds: ObsDataset, lonlat) -> None:
    if cfg.write_pickles:
        save_pickle(res.to_reference_dict(), _pickle_path(cfg, ds, res.date))
    if cfg.write_quicklook:
        write_result_quicklook(res, *lonlat, ds.grid_res_km, cfg.outdir)


def run_season(
    ds: ObsDataset,
    config: SeasonConfig,
    days: Optional[Union[Sequence[int], slice]] = None,
    prior_fn: Optional[Callable[[int], float]] = None,
    fyi: Optional[np.ndarray] = None,
    precomputed_hypers: Optional[Union[str, dict]] = None,
    log: Callable[[str], None] = print,
    device: Union[str, torch.device] = "cuda",
    cell_sharding=None,
) -> list[DailyResult]:
    """Run every T-day window (or the given ``days`` start indices) on
    ``device``, in strided waves of up to ``config.day_parallel`` days;
    returns the results of the days run (not those resumed), in day order.

    ``days`` may be explicit window start indices, or a slice of the
    season's valid-window range (the CLI's ``--days``). ``prior_fn(day)``
    gives each day's prior; otherwise the CS2-FYI constant prior is taken
    from ``fyi`` (GPR_CS2S3.py:210-212). ``precomputed_hypers``: the
    quicklook path for every day (nothing is fitted, nothing chains).

    Wave j holds list positions ``[j::n_waves]``, so the day at position p
    starts from position p - 1, fitted one wave earlier; resumed days still
    feed their pickled hypers into the chain. At ``day_parallel`` 1 every
    wave is one day and the season runs day by day. ``cell_sharding``
    (``parallel.mesh.CellSharding``) splits every wave's buckets over its
    devices, as ``interpolate_days`` takes it.
    """
    cfg = config
    all_windows = range(ds.n_days - cfg.daily.window_days + 1)
    if days is None:
        days = all_windows
    elif isinstance(days, slice):
        days = all_windows[days]
    days = list(days)
    os.makedirs(cfg.outdir, exist_ok=True)
    lonlat = None
    if cfg.write_quicklook:
        lonlat = grid_lonlat(ds.x, ds.y)

    chaining = cfg.chain_warmstart and precomputed_hypers is None
    n_waves = max(1, -(-len(days) // max(1, cfg.day_parallel)))
    results_by_pos: dict[int, DailyResult] = {}
    chain_by_pos: dict[int, dict] = {}
    for j in range(n_waves):
        run_pos, inits = [], []
        for p in range(j, len(days), n_waves):
            date = ds.dates[days[p] + cfg.daily.t_mid]
            path = _pickle_path(cfg, ds, date)
            if cfg.resume and cfg.write_pickles and os.path.exists(path):
                log(f"[season] {date}: exists, skipping (resume)")
                if chaining:
                    chain = _resumed_chain(path, date)
                    if chain is not None:
                        chain_by_pos[p] = chain
                continue
            run_pos.append(p)
            inits.append(chain_by_pos.get(p - 1) if chaining else None)
        if not run_pos:
            continue
        t0 = time.perf_counter()
        res_list = interpolate_days(
            ds, [days[p] for p in run_pos], [_prior_for(days[p], prior_fn, fyi) for p in run_pos],
            cfg.daily, init_hypers=inits if any(i is not None for i in inits) else None,
            precomputed_hypers=precomputed_hypers, device=device, cell_sharding=cell_sharding,
        )
        wall = time.perf_counter() - t0
        n_cells = sum(int(np.isfinite(r.interp).sum()) for r in res_list)
        log(f"[season] wave {j + 1}/{n_waves} ({len(run_pos)} days): {n_cells} cells in "
            f"{wall:.1f}s ({n_cells / max(wall, 1e-9):.1f} cells/s)")
        for p, res in zip(run_pos, res_list):
            if chaining:
                chain_by_pos[p] = res.hypers
            results_by_pos[p] = res
            _write(res, cfg, ds, lonlat)
    return [results_by_pos[p] for p in sorted(results_by_pos)]
