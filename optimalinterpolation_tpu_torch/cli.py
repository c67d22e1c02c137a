"""Command-line interface of the PyTorch/CUDA port.

  python -m optimalinterpolation_tpu_torch daily ...
                                   one daily field: per-cell fit, predict,
                                   smoothing, second predict
  python -m optimalinterpolation_tpu_torch daily --hypers H.npz ...
                                   one quicklook daily field (predict only)
  python -m optimalinterpolation_tpu_torch season ... [--day-parallel W]
                                   a season of daily fields, chained day to
                                   day, in strided waves of W days
  python -m optimalinterpolation_tpu_torch bin     along-track binning of .proc
                                   files into a season pickle
  python -m optimalinterpolation_tpu_torch hypers  seasonal-average hyperparameter
                                   .npz from per-day result pickles, optionally
                                   regridded (for ``--hypers``)
  python -m optimalinterpolation_tpu_torch validate
                                   skill of per-day results against point
                                   observations
  python -m optimalinterpolation_tpu_torch synth   synthetic season generator
  python -m optimalinterpolation_tpu_torch cell    single-cell GP (exact |
                                   nystroem | svgp), the GP_example.ipynb
                                   workflow

Argument names, defaults and JSON output lines follow
``optimalinterpolation_tpu/cli.py`` for the commands and arguments kept.
``--hypers`` takes the ``.npz`` that either package's ``hypers`` command
writes. ``--device`` picks the card or, for tests and small runs, ``cpu``;
``--profile LOGDIR`` writes a ``torch.profiler`` Chrome trace of the run.
``--optimizer adam`` fits with Adam instead of L-BFGS (``daily``, ``season``
with waves of one day, ``cell --method exact``). ``cell --figure`` needs
matplotlib, checked before the fit. ``--devices N`` shards every bucket's
cells over N devices of ``--device``'s type (``daily``, ``season``; ``cell``
takes it and, as in the JAX package, fits its one cell on one device).
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
    p.add_argument("--optimizer", default="lbfgs", choices=["lbfgs", "adam"])
    p.add_argument("--dtype", default="float32")
    p.add_argument("--jitter", type=float, default=1e-6)
    p.add_argument("--prior-mean", type=float, default=None,
                   help="constant prior mean; otherwise --fyi is used")
    p.add_argument("--fyi", default=None, help="CS2 FYI .npy for the prior")
    p.add_argument("--prior-background", type=int, default=None,
                   metavar="N_DAYS",
                   help="spatially varying prior: the first-N_DAYS "
                        "all-satellite mean field with pole-hole fill "
                        "(dev/sparseGP_example.ipynb cell-1 background/"
                        "priorXS; reference uses 31 days)")
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
    p.add_argument("--devices", type=int, default=None,
                   help="shard cells across this many devices")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="write a torch.profiler trace of the run (host, and "
                        "the card's kernels) to LOGDIR (TensorBoard/Perfetto)")
    p.add_argument("--verbose", action="store_true",
                   help="per-stage and per-bucket INFO logs (cells, tiles, "
                        "iterations, seconds)")


def _prior(args, ds):
    """The day -> prior mean function the arguments ask for: a scalar or,
    with ``--prior-background``, one (G, G) field for every day."""
    if args.prior_mean is not None:
        return lambda day: args.prior_mean
    if args.prior_background:
        from optimalinterpolation_tpu_torch.data.prior import background_prior
        from optimalinterpolation_tpu_torch.io.quicklook import grid_lonlat

        _, lat = grid_lonlat(ds.x, ds.y)
        field = background_prior(ds.obs, lat, n_days=args.prior_background)
        return lambda day: field
    if args.fyi is not None:
        from optimalinterpolation_tpu_torch.data.prior import constant_fyi_prior

        fyi = np.load(args.fyi)
        return lambda day: constant_fyi_prior(fyi, day, offset=args.fyi_offset)
    raise SystemExit("provide --prior-mean or --fyi")


def _sharding(args):
    """None for one ``--device``; with ``--devices N``, the cells of every
    bucket sharded over N devices of ``--device``'s type (N CPU shards with
    ``--device cpu``). Raises where N cards do not exist."""
    if args.devices is None:
        return None
    import torch

    from optimalinterpolation_tpu_torch.parallel.mesh import cell_sharding, make_mesh

    return cell_sharding(make_mesh(args.devices, kind=torch.device(args.device).type))


def _profile(args):
    """The ``--profile`` trace around the run, else nothing."""
    import contextlib

    if args.profile:
        from optimalinterpolation_tpu_torch.utils.profiling import trace

        return trace(args.profile)
    return contextlib.nullcontext()


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
    prior = _prior(args, ds)(args.day)
    with _profile(args):
        res = interpolate_daily(ds, args.day, prior, cfg, precomputed_hypers=args.hypers,
                                device=args.device, cell_sharding=_sharding(args))
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


def cmd_cell(args):
    """Single-cell GP train/predict, the reference's notebook workflow
    (``cli.py:200-358``): ``GP_example.ipynb`` cell-3 (exact GP) and cell-5
    (Nystroem), ``dev/sparseGP_example.ipynb`` cell-5 (SVGP). Gathers the
    radius/window neighbourhood of one location, fits, predicts, and prints
    mean / std / lZ or NLL or ELBO / hyperparameters (``--figure``: the
    prior-vs-posterior figure and the training footprint map)."""
    import time

    import torch

    from optimalinterpolation_tpu_torch.data.neighbors import gather_neighborhoods
    from optimalinterpolation_tpu_torch.data.window import flatten_window
    from optimalinterpolation_tpu_torch.models import exact_gp
    from optimalinterpolation_tpu_torch.ops.kernels import Kernel

    if args.figure:  # checked before the fit, not after it
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise RuntimeError("cell --figure needs matplotlib, which is not installed") from e
    ds, _ = _setup(args)
    prior = _prior(args, ds)(args.day)
    if np.ndim(prior) == 2:  # a field: sampled at the nearest grid cell
        k = np.argmin((ds.x - args.x) ** 2 + (ds.y - args.y) ** 2)
        v = np.asarray(prior).ravel()[k]
        prior = float(v) if np.isfinite(v) else float(np.nanmean(prior))
    prior = float(prior)
    t_mid = args.window_days // 2
    date = ds.dates[args.day + t_mid]
    train = flatten_window(ds.obs[:, :, :, args.day : args.day + args.window_days], ds.x, ds.y)
    dtype = np.float64 if args.dtype == "float64" else np.float32
    batches = gather_neighborhoods(train, np.array([[args.x, args.y]]), t_star=float(t_mid),
                                   radius_m=args.radius_km * 1e3, batch_multiple=1, dtype=dtype)
    if not batches or int(batches[0].mask[0].sum()) == 0:
        raise SystemExit("no observations within the radius/window")
    b = batches[0]
    dev = torch.device(args.device)
    x, z, mask = (torch.from_numpy(a[0]).to(dev) for a in (b.x, b.z, b.mask))
    xstar = torch.from_numpy(b.xstar[0]).to(dev)[None]
    kind = Kernel(args.kernel)
    mean = torch.tensor(prior, dtype=x.dtype, device=dev)
    h0 = exact_gp.HYPER_INIT_LOG(ds.grid_res_km * 1e3, dtype=x.dtype, device=dev)
    out = {"date": date, "method": args.method, "n_points": int(b.mask[0].sum()),
           "prior_mean": prior}
    footprint_inducing = None

    with _profile(args):
        t0 = time.time()
        if args.method == "exact":
            from optimalinterpolation_tpu_torch.models.optimizer import (
                OptimizeConfig,
                optimize_mll,
            )

            cfg = OptimizeConfig(method=args.optimizer, max_iters=args.max_iters, kind=kind,
                                 jitter=args.jitter, restarts=args.restarts, ftol_abs=args.ftol)
            opt = optimize_mll(h0, x, (z - mean) * mask, mask, config=cfg)
            pred = exact_gp.predict(opt.log_hypers, x, z, xstar, mask, mean, kind=kind,
                                    jitter=args.jitter)
            log_h = opt.log_hypers
            out.update(mean=float(pred.mean[0]), std=float(pred.std[0]), lZ=float(pred.lZ),
                       prior_std=float(pred.prior_std[0]), nll=float(opt.nll),
                       iters=int(opt.iters))
        elif args.method == "nystroem":
            from optimalinterpolation_tpu_torch.models import bfgs
            from optimalinterpolation_tpu_torch.models.nystroem import (
                nystroem_nll,
                nystroem_predict,
            )

            valid = np.nonzero(b.mask[0])[0]
            m_lmk = min(args.landmarks, len(valid))
            rng = np.random.default_rng(args.seed)
            lmk = torch.from_numpy(rng.choice(valid, size=m_lmk, replace=False)).to(dev)
            zc = (z - mean) * mask

            def objective(h):
                return nystroem_nll(h, x, zc, lmk, mask, kind=kind, jitter=args.jitter)

            res = bfgs.minimize_bfgs(objective, h0, maxiter=args.max_iters)
            pred = nystroem_predict(res.x, x, z, xstar, lmk, mask, mean, kind=kind,
                                    jitter=args.jitter)
            log_h = res.x
            out.update(mean=float(pred.mean[0]), std=float(pred.std[0]), nll=float(res.fun),
                       landmarks=m_lmk)
        else:  # svgp (argparse's choices guard the method)
            from optimalinterpolation_tpu_torch.models.svgp import (
                SVGPConfig,
                svgp_fit,
                svgp_init,
                svgp_predict,
            )

            cfg = SVGPConfig(num_inducing=args.num_inducing, iterations=args.svgp_iters,
                             batch_size=args.svgp_batch, kind=kind)
            params0 = svgp_init(x, mask, cfg.num_inducing, h0, prior)
            fit = svgp_fit(params0, x, z, mask, torch.Generator(dev).manual_seed(args.seed),
                           config=cfg)
            pred = svgp_predict(fit.params, xstar, kind=kind)
            log_h = fit.params.log_hypers
            footprint_inducing = fit.params.z[:, :2].cpu().numpy()
            out.update(mean=float(pred.mean[0]), std=float(pred.std[0]),
                       elbo=float(fit.elbo_log[-1]), learned_mean=float(fit.params.mean))
        out["seconds"] = round(time.time() - t0, 3)
    out["hypers"] = {k: float(np.exp(v)) for k, v in
                     zip(("ell_x", "ell_y", "ell_t", "sf2", "sn2"), log_h.cpu().numpy())}

    if args.figure:
        from optimalinterpolation_tpu_torch import viz

        prior_std = out.get("prior_std", float(np.sqrt(out["hypers"]["sf2"])))
        pdf_path = f"{args.figure}_pdf.png"
        viz.plot_prior_posterior(prior, prior_std, out["mean"], out["std"], path=pdf_path)
        foot_path = f"{args.figure}_footprint.png"
        valid = b.mask[0] > 0
        viz.plot_training_footprint(b.x[0][valid, :2], b.z[0][valid], (args.x, args.y),
                                    radius_m=args.radius_km * 1e3,
                                    inducing_xy=footprint_inducing, path=foot_path)
        out["figures"] = [pdf_path, foot_path]
    print(json.dumps(out))


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
    prior_fn = _prior(args, ds)
    with _profile(args):
        run_season(ds, cfg, days=args.days, prior_fn=prior_fn, precomputed_hypers=args.hypers,
                   device=args.device, cell_sharding=_sharding(args))


def _scan_results(indir: str, grid_res: int) -> list[tuple[str, str]]:
    """Sorted (date, path) pairs for per-day result pickles in ``indir``;
    non-conforming filenames matched by the glob are reported and skipped."""
    import glob
    import re

    out = []
    for f in sorted(glob.glob(os.path.join(indir, f"CS2S3_*_{grid_res}km.pkl"))):
        m = re.search(r"CS2S3_(\d{8})_", os.path.basename(f))
        if not m:
            print(f"skipping non-conforming result file: {f}", file=sys.stderr)
            continue
        out.append((m.group(1), f))
    if not out:
        raise SystemExit(f"no CS2S3_YYYYMMDD_{grid_res}km.pkl in {indir}")
    return out


def _grid_axes(datapath: str, grid_res: int):
    """1-D cell-coordinate axes from the x_/y_{res}km.npy grids
    ([ix, iy] layout: x varies along axis 0, y along axis 1)."""
    x = np.load(os.path.join(datapath, f"x_{grid_res}km.npy"))[:, 0]
    y = np.load(os.path.join(datapath, f"y_{grid_res}km.npy"))[0, :]
    return x, y


def cmd_hypers(args):
    """Seasonal-average hyperparameter fields -> ``.npz`` (quicklook scheme).

    The reference's quicklook production skips per-cell optimization and
    reuses seasonal-average hyperparameters from 50 km runs regridded to the
    25 km grid (``QuickLook Data/README.txt:1``; ``GPR3D(opt=False)``,
    ``GPR_CS2S3.py:170-172``). Averages the (smoothed) hyper fields of saved
    per-day result pickles, optionally regrids them to a target resolution,
    and writes the ``.npz`` that ``daily``/``season`` take with ``--hypers``.
    """
    import warnings

    from optimalinterpolation_tpu_torch.io.pickles import load_pickle
    from optimalinterpolation_tpu_torch.pipeline.daily import HYPER_NAMES

    files = _scan_results(args.indir, args.grid_res)
    suffix = "" if args.raw else "_smth"
    stacks = {n: [] for n in HYPER_NAMES}
    for date, f in files:
        d = load_pickle(f)
        for n in HYPER_NAMES:
            stacks[n].append(np.asarray(d[f"{date}_{n}{suffix}"], np.float64))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN pixels
        avg = {n: np.nanmean(np.stack(s), axis=0) for n, s in stacks.items()}

    if args.target_grid_res and args.target_grid_res != args.grid_res:
        from optimalinterpolation_tpu_torch.data.regrid import regrid_field

        if args.datapath is None:
            raise SystemExit("--datapath required for regridding (grid .npy)")
        sx, sy = _grid_axes(args.datapath, args.grid_res)
        dx, dy = _grid_axes(args.target_datapath or args.datapath, args.target_grid_res)
        om = "builtin" if args.ocean_mask == "builtin" else None
        avg = {n: regrid_field(v.T, sx, sy, dx, dy, fill=not args.no_fill, ocean_mask=om).T
               for n, v in avg.items()}

    np.savez(args.out, **avg)
    print(json.dumps({
        "out": args.out, "days": len(files),
        "finite_cells": int(np.isfinite(avg["ell_x"]).sum()),
        "shape": list(avg["ell_x"].shape),
    }))


def cmd_validate(args):
    """Skill of saved daily fields against independent point observations
    (the reference's empty ``OIB/`` validation slot, C17).

    ``--points`` is an ``.npz`` with arrays ``x``, ``y`` [m, projected],
    ``date`` ('YYYYMMDD' strings) and ``value`` [m].
    """
    from optimalinterpolation_tpu_torch.io.pickles import load_pickle
    from optimalinterpolation_tpu_torch.validation import PointObs, validate_fields

    z = np.load(args.points, allow_pickle=False)
    obs = PointObs(x=z["x"], y=z["y"], date=z["date"].astype(str), value=z["value"])
    suffix = "_smth" if args.smoothed else ""
    fields, uncertainties = {}, {}
    for date, f in _scan_results(args.indir, args.grid_res):
        d = load_pickle(f)
        fields[date] = np.asarray(d[f"{date}_interp{suffix}"])
        uncertainties[date] = np.asarray(d[f"{date}_interp_error{suffix}"])
    x_axis, y_axis = _grid_axes(args.datapath, args.grid_res)
    stats = validate_fields(obs, fields, x_axis, y_axis, uncertainties=uncertainties)
    print(json.dumps({"days": len(fields), **stats.to_dict()}))


def cmd_bin(args):
    from optimalinterpolation_tpu_torch.data.binner import run_season_binning

    fields = run_season_binning(args.datapath, args.outdir, args.sat, args.season,
                                args.grid_res)
    print(json.dumps({"days_binned": len(fields)}))


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
                   help="also write the quicklook NetCDF (reference schema)")
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

    p = sub.add_parser("cell", help="single-cell GP at one location (exact | nystroem | svgp)")
    _add_daily_args(p)
    p.add_argument("--day", type=int, default=0, help="window start index")
    p.add_argument("--x", type=float, required=True,
                   help="projected x of the cell [m] (GP_example: 0.94e6)")
    p.add_argument("--y", type=float, required=True,
                   help="projected y of the cell [m] (GP_example: 3.5e5)")
    p.add_argument("--method", default="exact", choices=["exact", "nystroem", "svgp"])
    p.add_argument("--landmarks", type=int, default=925,
                   help="Nystroem rank M (reference demo: 925)")
    p.add_argument("--num-inducing", type=int, default=50)
    p.add_argument("--svgp-iters", type=int, default=10_000)
    p.add_argument("--svgp-batch", type=int, default=100)
    p.add_argument("--seed", type=int, default=0, help="landmark / minibatch sampling seed")
    p.add_argument("--figure", default=None,
                   help="path prefix: writes <prefix>_pdf.png (paper Fig. 2) and "
                        "<prefix>_footprint.png (needs matplotlib)")
    p.set_defaults(fn=cmd_cell)

    p = sub.add_parser("bin", help="along-track binning (L0)")
    p.add_argument("--datapath", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--sat", required=True)
    p.add_argument("--season", default="2018-2019")
    p.add_argument("--grid-res", type=int, default=25)
    p.set_defaults(fn=cmd_bin)

    p = sub.add_parser(
        "hypers",
        help="seasonal-average hyperparameter .npz (quicklook opt=False path)",
    )
    p.add_argument("--indir", required=True,
                   help="directory of per-day CS2S3_*_{res}km.pkl results")
    p.add_argument("--grid-res", type=int, default=50)
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--raw", action="store_true",
                   help="average the raw per-cell hypers instead of smoothed")
    p.add_argument("--datapath", default=None,
                   help="directory with x_/y_{res}km.npy grids (regrid only)")
    p.add_argument("--target-grid-res", type=int, default=None,
                   help="regrid the averages to this resolution "
                        "(reference: 50 -> 25)")
    p.add_argument("--target-datapath", default=None,
                   help="grid .npy dir for the target res (default --datapath)")
    p.add_argument("--no-fill", action="store_true",
                   help="skip nearest-neighbour fill outside the footprint")
    p.add_argument("--ocean-mask", choices=("footprint", "builtin"),
                   default="footprint",
                   help="'builtin' = the committed quicklook-derived "
                        "ice-capable-ocean mask (replaces the reference's "
                        "global_land_mask; real 2018-2019 domain only); "
                        "'footprint' = the regridded field's own validity")
    p.set_defaults(fn=cmd_hypers)

    p = sub.add_parser(
        "validate",
        help="skill metrics of saved daily fields vs point observations (OIB)",
    )
    p.add_argument("--indir", required=True,
                   help="directory of per-day CS2S3_*_{res}km.pkl results")
    p.add_argument("--datapath", required=True,
                   help="directory with x_/y_{res}km.npy grids")
    p.add_argument("--grid-res", type=int, default=25)
    p.add_argument("--points", required=True,
                   help=".npz with x, y [m], date [YYYYMMDD], value [m]")
    p.add_argument("--smoothed", action="store_true",
                   help="validate the smoothed-hyper pass-2 fields")
    p.set_defaults(fn=cmd_validate)

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
