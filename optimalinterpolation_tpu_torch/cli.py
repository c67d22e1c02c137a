"""Command-line interface of the PyTorch/CUDA port.

  python -m optimalinterpolation_tpu_torch daily --hypers H.npz ...
                                   one quicklook daily field (predict only)
  python -m optimalinterpolation_tpu_torch synth   synthetic season generator

Argument names and defaults follow ``optimalinterpolation_tpu/cli.py`` for
the arguments kept. ``daily`` needs ``--hypers`` (the ``.npz`` that the JAX
package's ``hypers`` subcommand writes) until pass 1 is ported. ``--device``
picks the card or, for tests and small runs, ``cpu``.
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--dtype", default="float32")
    p.add_argument("--jitter", type=float, default=1e-6)
    p.add_argument("--prior-mean", type=float, default=None,
                   help="constant prior mean; otherwise --fyi is used")
    p.add_argument("--fyi", default=None, help="CS2 FYI .npy for the prior")
    p.add_argument("--fyi-offset", type=int, default=16,
                   help="FYI product start relative to the season start "
                        "(reference product: 16; synthetic/aligned: 0)")
    p.add_argument("--outdir", default=".")
    p.add_argument("--hypers", required=True,
                   help=".npz of precomputed hyperparameter fields "
                        "(ell_x, ell_y, ell_t, sf2, sn2): the quicklook "
                        "opt=False path")
    p.add_argument("--device", default="cuda",
                   help="torch device that runs the predict (default cuda)")
    p.add_argument("--verbose", action="store_true",
                   help="per-bucket INFO logs (cells, tiles, seconds)")


def _prior(args, ds, day: int) -> float:
    if args.prior_mean is not None:
        return args.prior_mean
    if args.fyi is not None:
        from optimalinterpolation_tpu_torch.data.prior import constant_fyi_prior

        return constant_fyi_prior(np.load(args.fyi), day, offset=args.fyi_offset)
    raise SystemExit("provide --prior-mean or --fyi")


def cmd_daily(args):
    import torch

    from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season
    from optimalinterpolation_tpu_torch.io.pickles import save_pickle
    from optimalinterpolation_tpu_torch.ops.kernels import Kernel
    from optimalinterpolation_tpu_torch.pipeline.daily import (
        DailyConfig,
        interpolate_daily,
    )

    if args.verbose:
        import logging

        logging.basicConfig(level=logging.INFO, format="%(message)s")
        logging.getLogger("optimalinterpolation_tpu_torch").setLevel(logging.INFO)
    # Full float32 in the blocked Cholesky's products (TF32 keeps ~3 digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = read_freeboard_season(args.datapath, args.grid_res, args.season)
    cfg = DailyConfig(
        window_days=args.window_days, radius_km=args.radius_km,
        kind=Kernel(args.kernel), dtype=args.dtype, jitter=args.jitter,
    )
    res = interpolate_daily(
        ds, args.day, _prior(args, ds, args.day), cfg,
        precomputed_hypers=args.hypers, device=args.device,
    )
    os.makedirs(args.outdir, exist_ok=True)
    out = os.path.join(args.outdir, f"CS2S3_{res.date}_{ds.grid_res_km}km.pkl")
    save_pickle(res.to_reference_dict(), out)
    print(json.dumps({"date": res.date, "output": out,
                      "cells": int(np.isfinite(res.interp).sum())}))


def cmd_synth(args):
    from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season

    make_synthetic_season(
        args.outdir, grid_res_km=args.grid_res, n_days=args.n_days, seed=args.seed
    )
    print(json.dumps({"outdir": args.outdir, "n_days": args.n_days}))


def main(argv=None):
    ap = argparse.ArgumentParser("optimalinterpolation_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("daily", help="produce one quicklook daily field")
    _add_daily_args(p)
    p.add_argument("--day", type=int, default=0, help="window start index")
    p.set_defaults(fn=cmd_daily)

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
