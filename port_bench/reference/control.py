"""The control of the comparison: the reference itself put in the program's
place, one precision step below what the configuration states, judged by
the same numbers as the program. The configuration states float32 with
TF32 off, so the control runs the reference's predict and fit in float32
with TF32 on (on the card; a CPU has no TF32, so there it is float32
alone), and its smoothing, which the program runs in float64, in float32.

It needs no run of the program: it makes the cell's season, and draws its
share and hyper fields from the seed, as a run does, samples cells of every bucket of
the windows it is given (a run's first days or first wave), and returns the
numbers the judge would compare (``predict_err_m``; for fit cells also
``fit_gap_gm_nats`` and ``smooth_rel_err``).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.datagen import fields as F
from port_bench.datagen import season as S
from port_bench.reference import gather as G
from port_bench.reference import gp
from port_bench.reference.smooth import smooth_field
from port_bench.reference import judge as J
from port_bench.reference.judge import (
    HYPER_NAMES,
    DayInputs,
    _chunks,
    _pad,
    fit_subsample,
    reference_gap,
    reference_predict,
    smooth_bounds,
    smooth_std,
)


def _sample(day: DayInputs, buckets, per_bucket: int, rng) -> list:
    """Rows as the program's buckets would hold them: (row dict, points)."""
    counts = day.counts[day.active_ij]
    caps = np.array([G.bucket_of(int(c), buckets) for c in counts])
    out = []
    for cap in sorted(set(caps.tolist())):
        cells = np.nonzero(caps == cap)[0]
        for r in np.sort(rng.choice(len(cells), min(per_bucket, len(cells)), replace=False)):
            cell, idx = day.points(int(cells[r]))
            pts = np.concatenate([day.xyt[idx], day.z[idx, None]], axis=1)
            if len(pts) > cap:  # the nearest, as the program keeps them
                d = np.hypot(pts[:, 0] - day.x[cell], pts[:, 1] - day.y[cell])
                pts = pts[np.argsort(d, kind="stable")[:cap]]
            row = {"row": int(r), "cell_index": int(cells[r]), "x": np.zeros((cap, 3))}
            out.append((row, pts, cell))
    return out


def control_numbers(cfg: dict, fits: bool, seed: int, windows, device="cuda") -> dict:
    """The control's numbers on the days of ``windows`` of ``cfg``'s cell."""
    on_card = str(device).startswith("cuda")
    low = torch.float32
    rng_share, rng_fields, rng_sample = F.streams(seed, 3)
    season = S.make_season(cfg["grid_res_km"], cfg["n_days"], tuple(cfg["tracks_per_day"]),
                           cfg["noise_std"], cfg["season_seed"])
    shape = season.x.shape
    share = (F.share_mask(shape, cfg["cell_share"], rng_share) if cfg["cell_share"] < 1.0
             else np.ones(shape, bool))
    hyp = F.hyper_fields(season.x, season.y, cfg["hyper_constants"],
                         cfg["hyper_log_amplitude"], cfg["hyper_waves"], rng_fields)
    buckets = tuple(cfg["buckets"])
    prior, jitter = float(cfg["prior_mean"]), float(cfg["jitter"])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    pred_err, smooth_err, gaps = 0.0, 0.0, []
    try:
        for w in windows:
            day = DayInputs(season, share, cfg, w)
            rows = _sample(day, buckets, J.CHECK_CELLS_PER_BUCKET, rng_sample)
            probs = [p for _, p, _ in rows]
            xst = [np.array([day.x[c], day.y[c], day.t_mid]) for _, _, c in rows]
            lh = [np.log([hyp[n][c] for n in HYPER_NAMES]) for _, _, c in rows]
            ref_m, ref_s = reference_predict(probs, xst, lh, prior, jitter, torch.float64, device)
            torch.backends.cuda.matmul.allow_tf32 = on_card
            low_m, low_s = reference_predict(probs, xst, lh, prior, jitter, low, device)
            torch.backends.cuda.matmul.allow_tf32 = tf32
            err = np.concatenate([np.abs(low_m - ref_m), np.abs(low_s - ref_s)])
            pred_err = max(pred_err, float(np.max(np.where(np.isfinite(err), err, np.inf))))
            if not fits:
                continue
            subs, starts = [], []
            for (row, pts, _), h in zip(rows, lh):
                sub = fit_subsample(day, row, pts, buckets, int(cfg["opt_n_max"]))
                if sub is not None:
                    subs.append(sub)
                    starts.append(h)
            fitted = []
            torch.backends.cuda.matmul.allow_tf32 = on_card
            for sl in _chunks(subs):
                x, z, m = _pad(subs[sl], low, device)
                h0 = torch.tensor(np.stack(starts[sl]), dtype=low, device=device)
                fitted.extend(gp.lbfgs(h0, x, (z - prior) * m, m, jitter)[0].double().cpu().numpy())
            torch.backends.cuda.matmul.allow_tf32 = tf32
            gaps.extend(reference_gap(subs, fitted, prior, jitter, device).tolist())
            std, bounds = smooth_std(cfg["grid_res_km"]), smooth_bounds(cfg)
            for name in HYPER_NAMES:
                field = np.where(day.ice, hyp[name], np.nan)
                ref = smooth_field(field, bounds[name], day.ice, std)[day.active_ij]
                got = smooth_field(field, bounds[name], day.ice, std, np.float32)[day.active_ij]
                smooth_err = max(smooth_err, float(np.max(np.abs(got - ref) / np.abs(ref))))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out = {"predict_err_m": pred_err}
    if fits:
        out["fit_gap_gm_nats"] = J.gap_gm(gaps, float(cfg["ftol"]))
        out["smooth_rel_err"] = smooth_err
    return out

