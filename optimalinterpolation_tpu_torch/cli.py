"""Command-line interface of the PyTorch/CUDA port.

  python -m optimalinterpolation_tpu_torch daily ...
                                   one daily field: per-cell fit, predict,
                                   smoothing, second predict
  python -m optimalinterpolation_tpu_torch daily --hypers H.npz ...
                                   one quicklook daily field (predict only)
  python -m optimalinterpolation_tpu_torch season ... [--day-parallel W]
                                   a season of daily fields, chained day to
                                   day, in strided waves of W days
  python -m optimalinterpolation_tpu_torch synth   synthetic season generator

Argument names and defaults follow ``optimalinterpolation_tpu/cli.py`` for
the arguments kept. ``--hypers`` takes the ``.npz`` that the JAX package's
``hypers`` subcommand writes. ``--device`` picks the card or, for tests and
small runs, ``cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def _add_daily_args(p):
    p.add_argument("--datapath", required=True)
    p.add_argument("--grid-res", type=int, default=25)
    p.add_argument("--season", default="2018-2019")
    p.add_argument("--window-days", type=int, default=9)
    p.add_argument("--radius-km", type=float, default=300.0)
    p.add_argument("--kernel", default="matern32",
                   choices=["matern12", "matern32", "matern52", "se"])
    p.add_argument("--max-iters", type=int, default=60)
    p.add_argument("--ftol", type=float, default=1e-3,
                   help="NLL plateau stop (nats/iteration); 0 disables and "
                        "runs every cell to --max-iters / grad tolerance")
    p.add_argument("--restarts", type=int, default=1,
                   help="multi-restart optimization trajectories per cell")
    p.add_argument("--warmstart-n", type=int, default=1024,
                   help="optimize problems larger than this on a subsample "
                        "first, then fine-tune at full size; 0 disables")
    p.add_argument("--seed-stride", type=int, default=4,
                   help="spatial seeding: cold-optimize every Nth grid cell, "
                        "warm-start the rest from the nearest seed; 0 disables")
    p.add_argument("--opt-n-max", type=int, default=None,
                   help="cap hyperparameter estimation at a uniform N-point "
                        "subsample per cell (prediction stays full-N); "
                        "default 1024; 0 = full-N")
    p.add_argument("--optimizer", default="lbfgs", choices=["lbfgs"])
    p.add_argument("--dtype", default="float32")
    p.add_argument("--jitter", type=float, default=1e-6)
    p.add_argument("--prior-mean", type=float, default=None,
                   help="constant prior mean; otherwise --fyi is used")
    p.add_argument("--fyi", default=None, help="CS2 FYI .npy for the prior")
    p.add_argument("--fyi-offset", type=int, default=16,
                   help="FYI product start relative to the season start "
                        "(reference product: 16; synthetic/aligned: 0)")
    p.add_argument("--outdir", default=".")
    p.add_argument("--hypers", default=None,
                   help=".npz of precomputed hyperparameter fields "
                        "(ell_x, ell_y, ell_t, sf2, sn2): the quicklook "
                        "opt=False path, which skips the per-cell fit")
    p.add_argument("--device", default="cuda",
                   help="torch device that runs the fit and the predict "
                        "(default cuda)")
    p.add_argument("--verbose", action="store_true",
                   help="per-stage and per-bucket INFO logs (cells, tiles, "
                        "iterations, seconds)")


def _prior(args):
    """The day -> prior mean function the arguments ask for."""
    if args.prior_mean is not None:
        return lambda day: args.prior_mean
    if args.fyi is not None:
        from optimalinterpolation_tpu_torch.data.prior import constant_fyi_prior

        fyi = np.load(args.fyi)
        return lambda day: constant_fyi_prior(fyi, day, offset=args.fyi_offset)
    raise SystemExit("provide --prior-mean or --fyi")


def _setup(args):
    """Logging as ``--verbose`` asks, and full float32 in the blocked
    Cholesky's products (TF32 keeps ~3 digits). Returns the dataset and the
    daily configuration of the arguments."""
    import torch

    from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season
    from optimalinterpolation_tpu_torch.models.optimizer import OptimizeConfig
    from optimalinterpolation_tpu_torch.ops.kernels import Kernel
    from optimalinterpolation_tpu_torch.pipeline.daily import DailyConfig

    if args.verbose:
        import logging

        logging.basicConfig(level=logging.INFO, format="%(message)s")
        logging.getLogger("optimalinterpolation_tpu_torch").setLevel(logging.INFO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = read_freeboard_season(args.datapath, args.grid_res, args.season)
    cfg = DailyConfig(
        window_days=args.window_days, radius_km=args.radius_km,
        kind=Kernel(args.kernel),
        opt=OptimizeConfig(method=args.optimizer, max_iters=args.max_iters,
                           ftol_abs=args.ftol, restarts=args.restarts),
        dtype=args.dtype, jitter=args.jitter, warmstart_n=args.warmstart_n,
        spatial_seed_stride=args.seed_stride,
    )
    if args.opt_n_max is not None:
        cfg = dataclasses.replace(cfg, opt_n_max=args.opt_n_max)
    return ds, cfg


def cmd_daily(args):
    from optimalinterpolation_tpu_torch.io.pickles import save_pickle
    from optimalinterpolation_tpu_torch.pipeline.daily import interpolate_daily

    ds, cfg = _setup(args)
    res = interpolate_daily(
        ds, args.day, _prior(args)(args.day), cfg,
        precomputed_hypers=args.hypers, device=args.device,
    )
    os.makedirs(args.outdir, exist_ok=True)
    out = os.path.join(args.outdir, f"CS2S3_{res.date}_{ds.grid_res_km}km.pkl")
    save_pickle(res.to_reference_dict(), out)
    outputs = {"date": res.date, "output": out, "cells": int(np.isfinite(res.interp).sum())}
    if args.quicklook:
        from optimalinterpolation_tpu_torch.io.quicklook import (
            grid_lonlat,
            write_result_quicklook,
        )

        lon, lat = grid_lonlat(ds.x, ds.y)
        outputs["quicklook"] = write_result_quicklook(res, lon, lat, ds.grid_res_km,
                                                      args.outdir)
    print(json.dumps(outputs))


def _days_spec(spec: str):
    """``--days`` value -> slice over the season's valid window indices:
    ``"5"`` window 5 only; ``"2:10"``, ``"2:"``, ``":10"`` python slices;
    ``"0:30:3"`` every 3rd window. ``run_season`` applies the slice to its
    own valid-window range."""
    parts = spec.split(":")
    try:
        ints = [int(p) if p else None for p in parts]
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid --days {spec!r}: expected INT, START:STOP, or "
            "START:STOP:STEP (python slice semantics)"
        )
    if len(parts) == 1:
        i = ints[0]
        return slice(i, None if i == -1 else i + 1)
    if len(parts) > 3:
        raise argparse.ArgumentTypeError(f"invalid --days {spec!r}: at most START:STOP:STEP")
    return slice(*ints)


def cmd_season(args):
    from optimalinterpolation_tpu_torch.pipeline.season import SeasonConfig, run_season

    ds, daily = _setup(args)
    cfg = SeasonConfig(daily=daily, outdir=args.outdir, resume=not args.no_resume,
                       day_parallel=args.day_parallel)
    run_season(ds, cfg, days=args.days, prior_fn=_prior(args),
               precomputed_hypers=args.hypers, device=args.device)


def cmd_synth(args):
    from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season

    make_synthetic_season(
        args.outdir, grid_res_km=args.grid_res, n_days=args.n_days, seed=args.seed
    )
    print(json.dumps({"outdir": args.outdir, "n_days": args.n_days}))


def main(argv=None):
    ap = argparse.ArgumentParser("optimalinterpolation_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("daily", help="produce one daily field")
    _add_daily_args(p)
    p.add_argument("--day", type=int, default=0, help="window start index")
    p.add_argument("--quicklook", action="store_true",
                   help="also write the quicklook NetCDF (reference schema; needs h5py)")
    p.set_defaults(fn=cmd_daily)

    p = sub.add_parser("season", help="produce a season of daily fields")
    _add_daily_args(p)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--days", default=None, type=_days_spec,
                   metavar="START:STOP[:STEP]",
                   help="window start-index range (python slice semantics, "
                        "e.g. 0:30 or 0:30:3; a bare INT runs that one "
                        "window); default = every valid window")
    p.add_argument("--day-parallel", type=int, default=1, metavar="W",
                   help="process the season in strided waves of up to W "
                        "days stacked into one combined cell batch "
                        "(pipeline.multiday); 1 = one day at a time")
    p.set_defaults(fn=cmd_season)

    p = sub.add_parser("synth", help="generate a synthetic season")
    p.add_argument("--outdir", required=True)
    p.add_argument("--grid-res", type=int, default=25)
    p.add_argument("--n-days", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_synth)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
