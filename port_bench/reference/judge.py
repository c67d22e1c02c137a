"""The comparison that decides a run's ``correct``: the program's outputs
against the plain reference, recomputed from the inputs the benchmark made.

For each day of the window, from the season's arrays (never from what the
program read or derived), it recomputes:

* ``missing_cells``: active cells whose outputs are not finite (limit 0);
* ``gather_bad_cells``: sampled rows of the program's buckets whose cell,
  bucket or set of points differs from the reference neighbourhood (limit 0;
  a row over the largest bucket must hold a nearest subset of it);
* ``predict_err_m``: the largest gap, in metres, between the program's mean
  and standard deviation at the sampled cells and the reference predict at
  the hyperparameters the program wrote beside them (pass 1 at the fitted
  fields, pass 2 at the smoothed ones);
* ``fit_gap_gm_nats`` (fit cells): the geometric mean over the sampled
  cells of each fit's gap, the float64 NLL at the fitted hyperparameters
  minus what a float64 L-BFGS reaches from there, each gap floored at the
  stopping rule's ``ftol`` (gaps below it are inside the rule), on the
  problem the fit saw (the whole neighbourhood, or above ``opt_n_max``
  points the seeded subsample the program's rule draws: one
  ``default_rng(0)`` permutation per row of the wave's combined bucket, in
  row order, the wave's earlier days' rows first). A fault on
  any share of the rows moves it, each row by its own factor, where a
  median would see only a fault on more than half of them;
* ``smooth_rel_err`` (fit cells): the largest relative gap between the
  program's smoothed hyper fields and the reference smoothing of its fitted
  fields, over the active cells.

It follows the program stage by stage: each stage is judged on the program's
own output of the stage before (its buckets, its fitted fields), and the
rows' sample (``CHECK_CELLS_PER_BUCKET`` of each bucket) is drawn from the
seed when the buckets are made. It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import gather as G
from port_bench.reference import gp
from port_bench.reference.smooth import smooth_field

HYPER_NAMES = ("ell_x", "ell_y", "ell_t", "sf2", "sn2")
SIE_THRESHOLD = 0.15
# Rows of each bucket of each day that the judge recomputes.
CHECK_CELLS_PER_BUCKET = 8


def smooth_std(grid_res_km: int) -> float:
    """The reference's smoothing width (``GPR_CS2S3.py:299-302``)."""
    return 2.0 if grid_res_km == 25 else 1.0


def smooth_bounds(cfg: dict) -> dict:
    """The physical bounds each field is clipped at (``GPR_CS2S3.py:303-307``)."""
    r = cfg["radius_km"] * 1000.0
    return {"ell_x": 2.0 * r, "ell_y": 2.0 * r, "ell_t": float(cfg["window_days"]),
            "sf2": 0.1, "sn2": 0.05}


class DayInputs:
    """One window's reference data: its active cells, points and counts."""

    def __init__(self, season, share, cfg: dict, w: int):
        t_mid = cfg["window_days"] // 2
        self.w = w
        self.ice = (season.sic[:, :, w + t_mid] >= SIE_THRESHOLD) & share
        self.active_ij = np.nonzero(self.ice)
        self.gi, self.gj, self.xyt, self.z = G.window_points(
            season.obs, season.x, season.y, w, cfg["window_days"])
        self.offsets = G.disc_offsets(season.x, season.y, cfg["radius_km"] * 1000.0)
        per_cell = np.zeros(season.x.shape, np.int64)
        np.add.at(per_cell, (self.gi, self.gj), 1)
        self.counts = G.neighbour_counts(per_cell, self.offsets)
        self.shape = season.x.shape
        self.t_mid = t_mid
        self.x, self.y = season.x, season.y
        self._in_bucket = {}

    def in_bucket(self, n: int, buckets) -> np.ndarray:
        """Active-cell indices of the cells whose neighbourhood goes to the
        bucket of ``n`` points, in active-cell order."""
        if n not in self._in_bucket:
            counts = self.counts[self.active_ij]
            self._in_bucket[n] = np.nonzero(
                np.array([G.bucket_of(int(c), buckets) == n for c in counts], bool))[0]
        return self._in_bucket[n]

    def points(self, cell_index: int):
        """(cell (i, j), indices of its neighbourhood)."""
        cell = (int(self.active_ij[0][cell_index]), int(self.active_ij[1][cell_index]))
        return cell, G.neighbourhood(cell, self.gi, self.gj, self.offsets, self.shape)


def _sorted_rows(a: np.ndarray) -> np.ndarray:
    return a[np.lexsort(a.T[::-1])]


def check_row(day: DayInputs, row: dict, buckets) -> tuple:
    """Whether the program's captured bucket row holds the reference
    neighbourhood of its cell; returns (ok, points (k, 4) float64 for the
    reference to use, in the program's pre-shuffle order)."""
    cell, idx = day.points(row["cell_index"])
    n = row["x"].shape[0]
    k = int(row["mask"].sum())
    prog = np.concatenate([row["x"][:k], row["z"][:k, None]], axis=1).astype(np.float32)
    want_xstar = np.array([day.x[cell], day.y[cell], day.t_mid], np.float32)
    ok = (G.bucket_of(len(idx), buckets) == n and bool(np.all(row["mask"][:k] == 1))
          and bool(np.all(row["mask"][k:] == 0)) and np.array_equal(row["xstar"], want_xstar))
    ref = np.concatenate([day.xyt[idx], day.z[idx, None]], axis=1)
    if len(idx) <= n:
        ok = ok and k == len(idx) and np.array_equal(_sorted_rows(prog),
                                                     _sorted_rows(ref.astype(np.float32)))
        return ok, ref
    # over the largest bucket: n of the nearest, none nearer left out
    d_ref = np.hypot(ref[:, 0] - day.x[cell], ref[:, 1] - day.y[cell])
    d_prog = np.hypot(prog[:, 0].astype(np.float64) - day.x[cell],
                      prog[:, 1].astype(np.float64) - day.y[cell])
    kth = np.sort(d_ref)[n - 1]
    ref32 = {tuple(p) for p in ref.astype(np.float32)}
    ok = (ok and k == n and bool(np.all(d_prog <= kth + 1e-6 * kth))
          and all(tuple(p) in ref32 for p in prog))
    return ok, prog.astype(np.float64)


def fit_subsample(day: DayInputs, row: dict, pts: np.ndarray, buckets, n_max: int,
                  earlier=()):
    """The points the fit of ``row`` saw: all of them up to ``n_max``, else
    the first ``n_max`` after the program's rule shuffled the row: one
    ``default_rng(0)`` over the combined bucket of the row's wave, one
    permutation per row of more than one point, in row order. The rows of
    the wave's days before ``day`` (``earlier``, their ``DayInputs`` in wave
    order) come first, each day's in active-cell order; ``row["pos"]``
    (else ``row["row"]``) is the row's place there."""
    if len(pts) <= n_max:
        return pts
    n = row["x"].shape[0]
    ks = [d.counts[d.active_ij][d.in_bucket(n, buckets)] for d in earlier]
    cells = day.in_bucket(n, buckets)
    r = row.get("pos", row["row"]) - sum(len(k) for k in ks)
    if not 0 <= r < len(cells) or cells[r] != row["cell_index"]:
        return None  # the row is not where the program's rule puts it
    ks.append(day.counts[day.active_ij][cells[: r + 1]])
    rng = np.random.default_rng(0)
    perm = None
    for k in np.minimum(np.concatenate(ks), n):
        if k > 1:
            perm = rng.permutation(int(k))
    return pts[perm][:n_max]


def _pad(problems: list, dtype, device):
    """Stack (k_i, 4) point sets into padded x (B, n, 3), z (B, n), mask."""
    n = max(len(p) for p in problems)
    x = np.zeros((len(problems), n, 3))
    z = np.zeros((len(problems), n))
    m = np.zeros((len(problems), n))
    for i, p in enumerate(problems):
        x[i, :len(p)] = p[:, :3]
        z[i, :len(p)] = p[:, 3]
        m[i, :len(p)] = 1.0
    return [torch.tensor(a, dtype=dtype, device=device) for a in (x, z, m)]


def _chunks(problems: list) -> list:
    """Slices of ``problems`` small enough for the card: (B, n, n) float64
    buffers of up to 16 cells, 4 above 2,048 points."""
    size = 4 if max(len(p) for p in problems) > 2048 else 16
    return [slice(s, s + size) for s in range(0, len(problems), size)]


def reference_predict(problems, xstars, lh, prior, jitter, dtype, device):
    """Reference (mean, std) of each problem, numpy (B,), in chunks."""
    means, stds = [], []
    for sl in _chunks(problems):
        x, z, m = _pad(problems[sl], dtype, device)
        xs = torch.tensor(np.stack(xstars[sl]), dtype=dtype, device=device)
        h = torch.tensor(np.stack(lh[sl]), dtype=dtype, device=device)
        mean, std = gp.predict(h, x, z, xs, m, prior, jitter)
        means.append(mean.double().cpu().numpy())
        stds.append(std.double().cpu().numpy())
    return np.concatenate(means), np.concatenate(stds)


def reference_gap(problems, lh, prior, jitter, device):
    """The float64 fit gap (``gp.fit_gap``) of each problem at ``lh``."""
    out = []
    for sl in _chunks(problems):
        x, z, m = _pad(problems[sl], torch.float64, device)
        h = torch.tensor(np.stack(lh[sl]), dtype=torch.float64, device=device)
        out.append(gp.fit_gap(h, x, (z - prior) * m, m, jitter).cpu().numpy())
    return np.concatenate(out)


def _at(fields: dict, names, suffix: str, cell) -> np.ndarray:
    return np.log(np.array([fields[n + suffix][cell] for n in names], np.float64))


def gap_gm(gaps, floor: float) -> float:
    """The geometric mean of ``gaps`` (nats), each floored at ``floor``;
    infinite where a gap is not finite or there is none."""
    gaps = np.asarray(gaps, np.float64)
    if gaps.size == 0 or not np.all(np.isfinite(gaps)):
        return math.inf
    return float(np.exp(np.mean(np.log(np.maximum(gaps, floor)))))


def judge(season, share, cfg: dict, fits: bool, days: list, quicklook_hypers=None,
          device="cpu", gaps_out=None) -> dict:
    """The run's compared numbers. ``days``: one dict a window day, with
    ``w``, ``fields`` (name -> (G, G): ``interp``, ``interp_error``,
    ``interp_smth``, ``interp_error_smth``, the five hypers and their
    ``_smth``), ``rows`` (captured bucket rows: ``row``, ``cell_index``,
    ``x``, ``z``, ``mask``, ``xstar``, and ``pos``, the row's place in its
    wave's combined bucket) and ``wave`` (the windows of the call that ran
    the day, in wave order; the day alone where absent), days of one wave
    next to each other. ``gaps_out``, a list, receives
    each sampled fit's gap in nats."""
    buckets = tuple(cfg["buckets"])
    prior, jitter = float(cfg["prior_mean"]), float(cfg["jitter"])
    std = smooth_std(cfg["grid_res_km"])
    bounds = smooth_bounds(cfg)
    out_fields = ("interp_smth", "interp_error_smth") + (("interp", "interp_error") if fits else ())
    missing = bad_rows = 0
    pred_err = smooth_err = 0.0
    gaps = []
    inputs = {}  # window -> DayInputs, of the current wave's windows
    for d in days:
        wave = tuple(d.get("wave", (d["w"],)))
        inputs = {w: v for w, v in inputs.items() if w in wave}
        for w in wave[: wave.index(d["w"]) + 1]:
            if w not in inputs:
                inputs[w] = DayInputs(season, share, cfg, w)
        day = inputs[d["w"]]
        earlier = [inputs[w] for w in wave[: wave.index(d["w"])]]
        f = d["fields"]
        finite = np.ones(int(day.ice.sum()), bool)
        for name in out_fields:
            finite &= np.isfinite(f[name][day.active_ij])
        missing += int((~finite).sum())

        problems, xstars, cells, rows = [], [], [], []
        if not d["rows"]:
            bad_rows += 1  # the program's buckets were never seen: nothing is judged
        for row in d["rows"]:
            ok, pts = check_row(day, row, buckets)
            cell = (int(day.active_ij[0][row["cell_index"]]),
                    int(day.active_ij[1][row["cell_index"]]))
            if not ok:
                bad_rows += 1
                continue
            problems.append(pts)
            xstars.append(np.array([day.x[cell], day.y[cell], day.t_mid], np.float64))
            cells.append(cell)
            rows.append(row)
        if not problems:
            continue
        passes = [("_smth", "interp_smth", "interp_error_smth")]
        if fits:
            passes.append(("", "interp", "interp_error"))
        for suffix, mean_name, std_name in passes:
            if quicklook_hypers is not None:
                lh = [_at(quicklook_hypers, HYPER_NAMES, "", c) for c in cells]
            else:
                lh = [_at(f, HYPER_NAMES, suffix, c) for c in cells]
            mean, sd = reference_predict(problems, xstars, lh, prior, jitter,
                                         torch.float64, device)
            got_m = np.array([f[mean_name][c] for c in cells])
            got_s = np.array([f[std_name][c] for c in cells])
            err = np.concatenate([np.abs(got_m - mean), np.abs(got_s - sd)])
            pred_err = max(pred_err, float(np.max(np.where(np.isfinite(err), err, np.inf))))
        if fits:
            subs, lhs = [], []
            for row, pts, c in zip(rows, problems, cells):
                sub = fit_subsample(day, row, pts, buckets, int(cfg["opt_n_max"]), earlier)
                if sub is None:
                    bad_rows += 1
                    continue
                subs.append(sub)
                lhs.append(_at(f, HYPER_NAMES, "", c))
            if subs:
                gaps.extend(reference_gap(subs, lhs, prior, jitter, device).tolist())
            for name in HYPER_NAMES:
                ref = smooth_field(f[name], bounds[name], day.ice, std)
                got = f[name + "_smth"]
                a, b = got[day.active_ij], ref[day.active_ij]
                rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
                smooth_err = max(smooth_err, float(np.max(np.where(np.isfinite(rel), rel,
                                                                   np.inf), initial=0.0)))
    if gaps_out is not None:
        gaps_out.extend(gaps)
    numbers = {"missing_cells": missing, "gather_bad_cells": bad_rows, "predict_err_m": pred_err}
    if fits:
        numbers["fit_gap_gm_nats"] = gap_gm(gaps, float(cfg["ftol"]))
        numbers["smooth_rel_err"] = smooth_err
    return numbers
