"""Two-pass daily pan-Arctic interpolation (reference layer L3).

PyTorch counterpart of ``optimalinterpolation_tpu/pipeline/daily.py``: the
production flow of the reference's ``GPR_CS2S3.py:201-336``,

  pass 1  optimize + predict every active cell          (:248-297)
  smooth  clip + NaN-aware Gaussian smooth of the five
          hyperparameter fields                          (:299-307)
  pass 2  re-predict every cell with the smoothed hypers (:311-334)

and, with ``precomputed_hypers``, its quicklook scheme ``GPR3D(opt=False)``
(``:169-186``): one predict pass with given (G, G) hyperparameter fields.

Cells are gathered into fixed-size neighborhood buckets (``data.neighbors``).
The fit of a bucket is one lockstep L-BFGS over all its cells
(``models.optimizer.optimize_mll_chunked``; objective K3, or the blocked
or Nystrom objective where ``OptimizeConfig`` routes it), warm-started from
a sublattice of seed cells and through a cascade of growing subsamples; the
bucket's arrays and the L-BFGS state stay on the device from the first stage
to the last. With ``OptimizeConfig(method="adam")`` (``daily.py:903-927``)
there is no seed pass and no cascade: :func:`_fit_adam` fits every row from
x0 at the bucket's full capacity, chunk by chunk. Each predict runs in
chunks of one fixed tile size through ``models.exact_gp_batch.predict_batch``
(K2 for N <= 1024, the blocked path with K1 above), and each chunk's results
come back to the host in one copy.

Output keys replicate the reference result dict (``:290-307,333-334``).

This module holds the day's configuration, results and per-bucket steps; the
flow above runs in ``pipeline.multiday.interpolate_days``, of which
:func:`interpolate_daily` is the wave of one day, so a day and a wave of
days take one code path. The steps are cut so that a bucket's rows can be
split over shards (``cell_sharding``, ``parallel.mesh``): what is decided
on the whole bucket (:func:`_plan_fit`, :func:`_shuffle_for_adam`) runs
once before the split, and :func:`_fit_rows`, :func:`_fit_adam` and
:func:`_predict_bucket` run on any contiguous rows.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from optimalinterpolation_tpu_torch.data.neighbors import NeighborhoodBatch, default_buckets
from optimalinterpolation_tpu_torch.data.reader import ObsDataset
from optimalinterpolation_tpu_torch.data.regrid import nearest_fill
from optimalinterpolation_tpu_torch.models.exact_gp_batch import predict_batch
from optimalinterpolation_tpu_torch.models.optimizer import (
    OptimizeConfig,
    _resolve_backend,
    _seg_schedule,
    optimize_mll_batch,
    optimize_mll_chunked,
    routed_nystroem_m,
)
from optimalinterpolation_tpu_torch.ops import fused_gp
from optimalinterpolation_tpu_torch.ops.kernels import Kernel
from optimalinterpolation_tpu_torch.ops.smoothing import smooth_hyper_field

__all__ = ["HYPER_NAMES", "DailyConfig", "DailyResult", "load_hypers", "interpolate_daily"]

HYPER_NAMES = ("ell_x", "ell_y", "ell_t", "sf2", "sn2")

logger = logging.getLogger(__name__)

# Live (N, N) buffers per cell of the blocked predict: A and its factor, plus
# the block products' temporaries.
_BLOCKED_BUFFERS = 2.5
# Live (N, N) buffers per cell of the blocked objective with its gradient
# (ops/blocked_gp.py), counted from the code: the line search carries each
# live row's factor L (1) while the next trial builds A (the kernel build's
# d2, r, -r and exp: 4 at its peak) and factors it (A and L); the gradient
# holds L, T = L^-1 and, at 512-wide panels, T re-blocked at 128 (3), plus
# the einsums' copies. Measured on an H100 (chip_smoke.py objectives phase,
# 16 rows, carried factors alive through the next trial and the gradient):
# 5.13 at N = 1024, 5.25 at N = 2048.
_BLOCKED_OBJECTIVE_BUFFERS = 6.0
# Live buffers per cell of the Nystrom objective with its autograd gradient
# (ops/nystroem_gp.py), counted from the code, in (N, M) arrays: what
# autograd keeps of the K_nm build (the three per-dimension differences, the
# square root, the exponential, 1 + r and the shape function, 7) plus K_nm
# and Phi, and the backward pass's gradients of them (3); in (M, M) arrays:
# the same of the K_mm build, both factorizations' L and W, core and the
# backward's products. Measured on an H100 (chip_smoke.py objectives phase,
# value + gradient of 16 rows at N = 1024 and 4096, M = 512): 11.4 (N, M)
# and 17.1 (M, M) buffers.
_NYSTROEM_NM_BUFFERS = 12
_NYSTROEM_MM_BUFFERS = 20
# Live (N, N) buffers per cell of the plain autograd objective (K, A, L, the
# solves and what autograd keeps for the backward pass): a count from the
# code, for the objective that ``"xla"`` forces; not measured on the card.
_AUTOGRAD_BUFFERS = 10


@dataclasses.dataclass(frozen=True)
class DailyConfig:
    """Production knobs (the reference hardcodes them as module globals,
    ``GPR_CS2S3.py:201-217``); defaults as in the JAX package's
    ``DailyConfig``, whose comments give the reason for each. The defaults
    of ``buckets``, ``opt_n_max`` and ``cascade_skip_tol`` read their
    environment knobs when a config is built, never at import."""

    window_days: int = 9  # T
    radius_km: float = 300.0
    kind: Kernel = Kernel.MATERN32
    opt: OptimizeConfig = OptimizeConfig()
    # OI_BUCKET_128 / OI_BUCKET_256 add the small buckets (default_buckets)
    buckets: Sequence[int] = dataclasses.field(default_factory=default_buckets)
    batch_multiple: int = 8
    dtype: str = "float32"
    jitter: float = 0.0
    # L-BFGS iterations per sweep of the segmented pass-1 fit; between
    # sweeps converged cells are compacted away.
    opt_segment_iters: int = 10
    # Subsampled warm start for problems larger than this: optimize on a
    # warmstart_n-point prefix of each (shuffled) neighborhood first, then on
    # doubled prefixes up to the full problem. 0 disables.
    warmstart_n: int = 1024
    # Cascade floor for seeded inits (a nearby cell's optimum needs only to
    # adapt to this cell's data, which is 8x cheaper at 512 than at 1024).
    warmstart_n_seeded: int = 512
    # Subsample cap of the seed pass, whose hypers exist only to be
    # nearest-filled into the second phase's inits. 0 disables.
    seed_opt_n: int = 512
    # Cap on the optimization problem of every bucket: hyperparameters are
    # estimated from a uniform opt_n_max-point subsample of each neighborhood
    # (prediction always uses the full neighborhood). 0 = off.
    # OI_OPT_N_MAX replaces the default.
    opt_n_max: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("OI_OPT_N_MAX", "1024")))
    # Spatial seeding: cold-optimize every stride-th grid cell, nearest-fill
    # their hypers over the grid, then optimize all cells from those. Skipped
    # when init_hypers are given. 0 or 1 disables.
    spatial_seed_stride: int = 4
    # Plateau tolerance (nats) of cascade stages, which only need to land in
    # the next stage's basin.
    warmstart_ftol: float = 0.1
    # A cell whose log-hypers moved less than this (inf-norm) during a
    # cascade stage skips the remaining cascade stages. 0 disables.
    # OI_CASCADE_SKIP_TOL replaces the default.
    cascade_skip_tol: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get("OI_CASCADE_SKIP_TOL", "0.05")))
    # A warm-started fine pass begins with a zero-iteration sweep (initial
    # NLL and gradient only), so cells converged at their start leave before
    # any line search.
    fine_entry_drain: bool = True
    # Device bytes one chunk of cells may hold in working memory: K2's or
    # K3's scratch per cell, or the blocked and Nystrom paths' buffers
    # (_chunk_rows). 16 GB leaves the rest of an 80 GB card to the
    # allocator.
    max_chunk_bytes: float = 16e9
    # Smoothing (reference: std = 2 at 25 km else 1, GPR_CS2S3.py:299-302;
    # clip vmaxes :303-307: ell_t T, sf2 0.1, sn2 0.05, ell_xy 2 * radius)
    smooth_std: Optional[float] = None
    sf2_vmax: float = 0.1
    sn2_vmax: float = 0.05

    @property
    def t_mid(self) -> int:
        return self.window_days // 2

    def smoothing_std(self, grid_res_km: int) -> float:
        if self.smooth_std is not None:
            return self.smooth_std
        return 2.0 if grid_res_km == 25 else 1.0


@dataclasses.dataclass
class DailyResult:
    """All per-date output fields on the (G, G) grid."""

    date: str
    interp: np.ndarray
    interp_error: np.ndarray
    lZ: np.ndarray
    hypers: dict  # name -> (G, G) field, names from HYPER_NAMES
    hypers_smth: dict
    interp_smth: np.ndarray
    interp_error_smth: np.ndarray

    def to_reference_dict(self) -> dict:
        """The reference's pickle schema (GPR_CS2S3.py:290-307,333-334)."""
        d = {
            f"{self.date}_interp": self.interp,
            f"{self.date}_interp_error": self.interp_error,
            f"{self.date}_lZ": self.lZ,
        }
        for name in HYPER_NAMES:
            d[f"{self.date}_{name}"] = self.hypers[name]
        for name in HYPER_NAMES:
            d[f"{self.date}_{name}_smth"] = self.hypers_smth[name]
        d[f"{self.date}_interp_smth"] = self.interp_smth
        d[f"{self.date}_interp_error_smth"] = self.interp_error_smth
        return d


def load_hypers(src: Union[str, dict]) -> dict:
    """Hyperparameter fields from the ``.npz`` that the JAX package's
    ``hypers`` subcommand writes, or from a dict of the same fields: (G, G)
    arrays in linear space keyed by HYPER_NAMES. Returns float64 copies;
    NaN entries stay NaN (their cells come out NaN)."""
    if not isinstance(src, dict):  # a path
        with np.load(src) as z:
            src = {k: z[k] for k in z.files}
    missing = [k for k in HYPER_NAMES if k not in src]
    if missing:
        raise ValueError(f"hyperparameter fields missing: {missing}")
    fields = {k: np.array(src[k], dtype=np.float64) for k in HYPER_NAMES}
    shapes = {f.shape for f in fields.values()}
    if len(shapes) != 1 or len(next(iter(shapes))) != 2:
        raise ValueError(f"hyperparameter fields must share one (G, G) shape, got {shapes}")
    return fields


def _filled_init(init_hypers: Union[str, dict], ds: ObsDataset, sie_day: np.ndarray) -> dict:
    """Warm-start fields (as :func:`load_hypers` takes them) for the day
    whose ice mask is ``sie_day``: newly active cells (the growing ice edge)
    have no init of their own and take the nearest cell's. All-NaN fields
    stay NaN, and their cells start from x0."""
    init = load_hypers(init_hypers)
    return {name: nearest_fill(init[name], ds.x, ds.y, valid_mask=np.isfinite(sie_day))
            for name in HYPER_NAMES}


def _prior_at_cells(prior_mean, shape, active_ij):
    """Per-active-cell prior means from a scalar or a (G, G) field.

    Returns ``(values, fill)``: one prior mean per active cell, plus the
    scalar used for NaN field cells and padded batch rows."""
    if np.ndim(prior_mean) == 0:
        fill = float(prior_mean)
        return np.full(len(active_ij[0]), fill), fill
    field = np.asarray(prior_mean, np.float64)
    if field.shape != shape:
        raise ValueError(f"prior field shape {field.shape} != grid shape {shape}")
    if not np.isfinite(field).any():
        raise ValueError("prior field is all-NaN")
    fill = float(np.nanmean(field))
    vals = field[active_ij]
    return np.where(np.isfinite(vals), vals, fill), fill


def _prior_rows(prior_cells, fill, cell_index, dtype):
    """Per-bucket-row prior means (padded rows get the fill scalar)."""
    rows = np.full((len(cell_index),), fill, dtype)
    real = cell_index >= 0
    rows[real] = prior_cells[cell_index[real]].astype(dtype)
    return rows


def _cascade_nys_m() -> int:
    """``OI_CASCADE_NYS_M``: the rank M of a Nystrom objective that cascade
    stages below the Nystrom threshold launch on, 0 (the default) for none
    (``daily.py:312-317``). Read at every call."""
    return int(os.environ.get("OI_CASCADE_NYS_M", "0"))


def _chunk_rows(capacity: int, n_rows: int, cfg: DailyConfig, itemsize: int,
                backend: Optional[str] = None) -> int:
    """One launch tile per bucket: the fewest chunks the byte budget allows
    (at least ``batch_multiple`` rows), split evenly, in multiples of
    ``batch_multiple``. ``backend`` (as ``optimizer._resolve_backend`` names
    it) sizes for that objective with its gradient: K3's two (N, N)
    scratches and its (N, 128) one per cell, or the buffers of the blocked,
    Nystrom or plain autograd objective; None sizes for the predict."""
    n2 = capacity * capacity
    if backend is None:
        if fused_gp.supported(capacity):
            per_row = n2 + capacity * fused_gp.BLK
        else:
            per_row = _BLOCKED_BUFFERS * n2
    elif backend == "fused":
        per_row = 2 * n2 + capacity * fused_gp.BLK
    elif backend == "blocked":
        per_row = _BLOCKED_OBJECTIVE_BUFFERS * n2
    elif backend.startswith("nystroem:"):
        mi = int(backend.split(":", 1)[1])
        per_row = _NYSTROEM_NM_BUFFERS * capacity * mi + _NYSTROEM_MM_BUFFERS * mi * mi
    else:
        per_row = _AUTOGRAD_BUFFERS * n2
    bm = cfg.batch_multiple
    cap = max(bm, int(cfg.max_chunk_bytes // (per_row * itemsize)) // bm * bm)
    n_chunks = -(-n_rows // cap)
    tile = -(-n_rows // n_chunks)
    return -(-tile // bm) * bm


def _chunks_of(b: NeighborhoodBatch, tile: int):
    """Cut a bucket into tiles of ONE size (the last padded with mask-0,
    cell_index -1 rows), so every chunk of a bucket has the same shapes."""
    total = len(b)
    for s in range(0, total, tile):
        e = min(s + tile, total)
        pad = tile - (e - s)

        def sl(a):
            if not pad:
                return a[s:e]
            return np.concatenate([a[s:e], np.zeros((pad,) + a.shape[1:], a.dtype)])

        idx = b.cell_index[s:e]
        if pad:
            idx = np.concatenate([idx, np.full(pad, -1, np.int64)])
        yield NeighborhoodBatch(
            x=sl(b.x), z=sl(b.z), mask=sl(b.mask), xstar=sl(b.xstar),
            cell_index=idx, n_valid_cells=max(0, min(b.n_valid_cells - s, e - s)),
        )


def _permute_valid_points(b: NeighborhoodBatch, seed: int = 0):
    """Shuffle each row's valid points in place with a fixed-seed generator
    (the JAX package's order exactly: one ``default_rng(seed)``, one
    ``permutation`` per row with more than one point, in row order).

    The GP does not depend on the order of its training points, but after
    the shuffle every PREFIX of a row is a uniform random subsample of its
    neighborhood, and the prefixes are nested: each cascade stage sees a
    superset of the previous stage's data."""
    rng = np.random.default_rng(seed)
    counts = b.mask.sum(axis=1).astype(np.int64)
    for r in range(len(b)):
        k = int(counts[r])
        if k > 1:
            p = rng.permutation(k)
            b.x[r, :k] = b.x[r, p]
            b.z[r, :k] = b.z[r, p]


def _prefix_subset(x, z, mask, n_sub: int):
    """The first ``n_sub`` neighbor slots of a bucket's device arrays (valid
    points sit at the front, so after :func:`_permute_valid_points` this is
    a uniform ``n_sub``-point subsample; the mask carries rows with fewer)."""
    if n_sub >= x.shape[1]:
        return x, z, mask
    return x[:, :n_sub].contiguous(), z[:, :n_sub].contiguous(), mask[:, :n_sub].contiguous()


def _smooth_fields(grids: dict, vmaxes: dict, sie_day, std: float) -> dict:
    """Clip + NaN-aware-smooth the 5 hyper fields (GPR_CS2S3.py:299-307), in
    float64 on the host (see ``ops.smoothing``)."""
    return {
        name: smooth_hyper_field(grids[name], vmaxes[name], sie_day, std=std).numpy()
        for name in HYPER_NAMES
    }


class _ShardStats(list):
    """One shard's stage entries (``parallel.mesh``): kept for the merge of
    ``pipeline.multiday``, which records and logs one entry a stage."""


def _stage(stats: Optional[list], stage: str, n: int, cells: int, t0: float,
           iters_sum: int = 0, **extra) -> None:
    """Record one finished stage: an entry of ``stats`` (where the caller
    gave a list) and an INFO record with the same fields (not for a
    shard's own entries, which are merged first)."""
    _record(stats, {"stage": stage, "n": n, "cells": cells, "wall_s": time.perf_counter() - t0,
                    "iters_sum": iters_sum, **extra})


def _record(stats: Optional[list], entry: dict) -> None:
    """Append a stage entry to ``stats`` (where given) and log it."""
    if stats is not None:
        stats.append(entry)
    if not isinstance(stats, _ShardStats):
        logger.info("stage %s", entry)


def _objective(backend: str) -> dict:
    """A stage entry's objective fields: ``backend`` (``"fused"``,
    ``"blocked"``, ``"nystroem"`` or ``"xla"``) and, where the Nystrom
    objective ran, its rank ``m`` (the JAX package's stage entries carry
    ``m`` alone)."""
    if backend.startswith("nystroem:"):
        return {"backend": "nystroem", "m": int(backend.split(":", 1)[1])}
    return {"backend": backend}


def _row_view(b: NeighborhoodBatch, rows: slice) -> NeighborhoodBatch:
    """Rows ``rows`` of a bucket as a bucket of their own: views of its
    arrays, no copy (real rows stay first)."""
    start, stop = rows.indices(len(b))[:2]
    return NeighborhoodBatch(
        x=b.x[start:stop], z=b.z[start:stop], mask=b.mask[start:stop],
        xstar=b.xstar[start:stop], cell_index=b.cell_index[start:stop],
        n_valid_cells=max(0, min(b.n_valid_cells - start, stop - start)),
    )


@dataclasses.dataclass(frozen=True)
class _FitPlan:
    """What the L-BFGS fit of a bucket decides on the whole bucket, before
    its rows are split over shards (``parallel.mesh``), so that a row's fit
    does not depend on the split: its start, the problem's size, whether
    the inits chain the bucket and whether the cascade runs."""

    h0: np.ndarray  # (B, 5) start log-hypers
    cap: int  # neighbour slots of the fit (a prefix of each row)
    chained: bool
    use_cascade: bool
    ws_n: int  # the cascade's first subsample
    prefix: str  # of the stage names: "seed:" in the seed pass


def _plan_fit(full_b: NeighborhoodBatch, x0: np.ndarray, init_at_cells: Optional[np.ndarray],
              cfg: DailyConfig, opt_cfg: OptimizeConfig, dtype, seed_init: bool = False,
              hypers_only: bool = False) -> _FitPlan:
    """The whole-bucket decisions of the pass-1 fit (:class:`_FitPlan`).
    Shuffles ``full_b``'s valid points in place where a subsample is taken:
    one ``default_rng(0)`` in row order over the whole bucket."""
    # The optimization problem's size: capped to a uniform subsample in the
    # seed pass and by opt_n_max; prediction always uses the full row.
    cap = full_b.capacity
    if hypers_only and cfg.seed_opt_n and cap > cfg.seed_opt_n:
        cap = cfg.seed_opt_n
    if cfg.opt_n_max and cap > cfg.opt_n_max:
        cap = cfg.opt_n_max
    h0_all = np.tile(np.asarray(x0, dtype)[None], (len(full_b), 1))
    chained = False
    if init_at_cells is not None:
        ci = full_b.cell_index
        realr = ci >= 0
        vals = np.full((len(full_b), 5), np.nan)
        vals[realr] = init_at_cells[ci[realr]]
        warm = np.isfinite(vals).all(axis=1)
        h0_all[warm] = np.log(np.maximum(vals[warm], 1e-300)).astype(dtype)
        # Inits that cover the bucket make the few cold cells (a newly active
        # ice edge) just take more fine iterations.
        chained = bool(warm.mean() > 0.5)
    # A day-chained init is THIS cell's optimum from an overlapping window,
    # and subsample stages would pull it away: no cascade. A spatial-seed
    # init is a NEARBY cell's optimum: cheap subsample stages adapt it to
    # this cell's data before the full problem.
    ws_n = cfg.warmstart_n_seeded if seed_init and cfg.warmstart_n_seeded else cfg.warmstart_n
    use_cascade = bool((not chained or seed_init) and ws_n and cap > ws_n)
    # A prefix will be taken, or the Nystrom objective's landmarks (the first
    # M slots) must be a uniform subsample.
    if cap < full_b.capacity or use_cascade or routed_nystroem_m(opt_cfg, cap):
        _permute_valid_points(full_b)
    return _FitPlan(h0_all, cap, chained, use_cascade, ws_n, "seed:" if hypers_only else "")


def _fit_rows(b: NeighborhoodBatch, h0: np.ndarray, prior_rows: np.ndarray, plan: _FitPlan,
              cfg: DailyConfig, opt_cfg: OptimizeConfig, dtype, device: torch.device,
              stats: Optional[list]) -> np.ndarray:
    """Pass-1 hyperparameter optimization of rows ``b`` of a bucket (all of
    it, or a shard's rows) from ``h0``, as ``plan`` decided for the bucket:
    the warm-start cascade (``DailyConfig.warmstart_n``) and the segmented,
    compacted fine pass. Returns the (B, 5) optimized log-hypers on the
    host."""
    cap, prefix = plan.cap, plan.prefix
    # Restarts probe other basins from x0: pointless from a warm start.
    fine_cfg = dataclasses.replace(opt_cfg, restarts=1) if plan.chained else opt_cfg

    # The rows go to the device once, centered, and stay there.
    x_d, m_d = (torch.from_numpy(a).to(device) for a in (b.x, b.mask))
    y_d = torch.from_numpy(b.z - prior_rows.astype(dtype)[:, None]).to(device)
    h_d = torch.from_numpy(np.ascontiguousarray(h0)).to(device)

    if plan.use_cascade:
        stage_ftol = max(opt_cfg.ftol_abs, cfg.warmstart_ftol)
        # Restarts run only in the cheapest first stage; later stages polish
        # the winner.
        stage_cfg = dataclasses.replace(
            opt_cfg, ftol_abs=stage_ftol, restarts=1 if plan.chained else opt_cfg.restarts
        )
        n_sub = plan.ws_n
        nys_m = _cascade_nys_m()
        active = torch.ones(len(b), dtype=torch.bool, device=device)
        while n_sub < cap:
            rows = torch.nonzero(active)[:, 0]
            if rows.numel() == 0:  # every cell drained: no launch at all
                n_sub *= 2
                continue
            t_stage = time.perf_counter()
            sx, sy, sm = _prefix_subset(x_d, y_d, m_d, n_sub)
            if rows.numel() < len(b):
                sx, sy, sm = (a.index_select(0, rows) for a in (sx, sy, sm))
            h_stage = h_d.index_select(0, rows)
            # OI_CASCADE_NYS_M (daily.py:593-616): a stage that production
            # routing keeps exact launches on a rank-M Nystrom objective;
            # stage_cfg, and the fine stage derived from it, keep their
            # routing.
            launch_cfg = stage_cfg
            if nys_m and n_sub >= 2 * nys_m and not routed_nystroem_m(stage_cfg, n_sub):
                launch_cfg = dataclasses.replace(stage_cfg, nystroem_min_n=n_sub,
                                                 nystroem_m=nys_m)
            stage_backend = _resolve_backend(launch_cfg, n_sub)
            wchunk = _chunk_rows(n_sub, launch_cfg.restarts * rows.numel(), cfg,
                                 dtype.itemsize, stage_backend)
            pre = optimize_mll_chunked(
                h_stage, sx, sy, sm, launch_cfg, chunk_rows=wchunk,
                segment_iters=cfg.opt_segment_iters,
            )
            if cfg.cascade_skip_tol > 0:
                moved = (pre.log_hypers - h_stage).abs().amax(dim=1)
                active[rows] = moved >= cfg.cascade_skip_tol
            h_d[rows] = pre.log_hypers
            stage_cfg = dataclasses.replace(opt_cfg, restarts=1, ftol_abs=stage_ftol)
            _stage(stats, prefix + "cascade", n_sub, int(rows.numel()), t_stage,
                   int(pre.iters.sum()), converged=int(pre.converged.sum()),
                   **_objective(stage_backend))
            n_sub *= 2
        fine_cfg = dataclasses.replace(stage_cfg, ftol_abs=opt_cfg.ftol_abs)

    t_opt = time.perf_counter()
    fx, fy, fm = _prefix_subset(x_d, y_d, m_d, cap)
    fine_backend = _resolve_backend(fine_cfg, cap)
    chunk = _chunk_rows(cap, fine_cfg.restarts * len(b), cfg, dtype.itemsize, fine_backend)
    # Warm entries (chained, seeded or cascade output) start with the
    # zero-iteration verify sweep; from a cold x0 nothing is converged yet.
    warm_entry = (plan.chained or plan.use_cascade) and cfg.fine_entry_drain
    opt_all = optimize_mll_chunked(
        h_d, fx, fy, fm, fine_cfg, chunk_rows=chunk, segment_iters=cfg.opt_segment_iters,
        lead_schedule=((0,) + _seg_schedule()) if warm_entry else None,
    )
    lh_all = opt_all.log_hypers.cpu().numpy()
    _stage(stats, prefix + "opt", cap, len(b), t_opt, int(opt_all.iters.sum()),
           converged=int(opt_all.converged.sum()), **_objective(fine_backend))
    return lh_all


def _shuffle_for_adam(full_b: NeighborhoodBatch, cfg: DailyConfig,
                      opt_cfg: OptimizeConfig) -> None:
    """The Adam fit's whole-bucket decision: shuffle the valid points (as
    :func:`_plan_fit` does) where the L-BFGS fit would take a subsample
    (``opt_n_max``) or the Nystrom objective's landmarks
    (``daily.py:497-513``), so a row's points stand in the JAX package's
    order."""
    n = full_b.capacity
    cap = min(n, cfg.opt_n_max) if cfg.opt_n_max else n
    if cap < n or routed_nystroem_m(opt_cfg, cap):
        _permute_valid_points(full_b)


def _fit_adam(full_b: NeighborhoodBatch, x0: np.ndarray, prior_rows: np.ndarray,
              cfg: DailyConfig, opt_cfg: OptimizeConfig, dtype, device: torch.device,
              stats: Optional[list]) -> np.ndarray:
    """The Adam fit of rows ``full_b`` of a bucket (all of it, or a shard's
    rows, after :func:`_shuffle_for_adam`; ``daily.py:903-927``): every row
    from x0 at the bucket's full capacity, on the objective ``opt_cfg``
    routes there, in tiles of one size that the chunk model gives for that
    objective and the restarts' rows. Returns the (B, 5) log-hypers on the
    host."""
    t0 = time.perf_counter()
    n = full_b.capacity
    backend = _resolve_backend(opt_cfg, n)
    # a cell's restarts are rows of the same launch: bytes a cell = restarts x a row's
    tile = _chunk_rows(n, len(full_b), cfg, dtype.itemsize * opt_cfg.restarts, backend)
    lh = np.empty((len(full_b), 5), dtype)
    converged = iters = 0
    for s, b in zip(range(0, len(full_b), tile), _chunks_of(full_b, tile)):
        take = min(tile, len(full_b) - s)
        prior = np.zeros(tile, dtype)
        prior[:take] = prior_rows[s : s + take]
        x, z, m = (torch.from_numpy(a).to(device) for a in (b.x, b.z, b.mask))
        h0 = torch.from_numpy(np.tile(np.asarray(x0, dtype)[None], (tile, 1))).to(device)
        res = optimize_mll_batch(h0, x, z - torch.from_numpy(prior).to(device)[:, None], m,
                                 opt_cfg)
        lh[s : s + take] = res.log_hypers[:take].cpu().numpy()
        converged += int(res.converged[:take].sum())
        iters += int(res.iters[:take].sum())
    _stage(stats, "opt", n, len(full_b), t0, iters, converged=converged, **_objective(backend))
    return lh


def _predict_bucket(full_b: NeighborhoodBatch, lh_rows: np.ndarray, prior_cells, prior_fill,
                    cfg: DailyConfig, dtype, device: torch.device):
    """Predict every row of a bucket with its own log-hypers ``lh_rows``
    (B, 5), in tiles of one size. Returns ``(out, tile)``: ``out`` (3, B) =
    posterior mean, std and lZ per row, on the host."""
    tile = _chunk_rows(full_b.capacity, len(full_b), cfg, dtype.itemsize)
    out = np.empty((3, len(full_b)))
    for s, b in zip(range(0, len(full_b), tile), _chunks_of(full_b, tile)):
        lh = np.zeros((len(b), 5), dtype=dtype)
        take = lh_rows[s : s + tile]
        lh[: len(take)] = take
        mean = _prior_rows(prior_cells, prior_fill, b.cell_index, dtype)
        args = [torch.from_numpy(a).to(device) for a in (lh, b.x, b.z, b.xstar, b.mask, mean)]
        pred = predict_batch(*args, kind=cfg.kind, jitter=cfg.jitter)
        got = torch.stack([pred.mean, pred.std, pred.lZ]).cpu().numpy()  # one copy
        out[:, s : s + tile] = got[:, : len(take)]
    return out, tile


def _log_rows(fields_at_cells: np.ndarray, cell_index: np.ndarray, dtype) -> np.ndarray:
    """Per-bucket-row log-hypers from per-active-cell linear values, as
    ``daily.py:824`` computes them (NaN stays NaN; padded rows get 0)."""
    lh = np.zeros((len(cell_index), 5), dtype=dtype)
    real = cell_index >= 0
    lh[real] = np.log(np.maximum(fields_at_cells[cell_index[real]], 1e-30))
    return lh


def interpolate_daily(
    ds: ObsDataset,
    day: int,
    prior_mean,
    config: Optional[DailyConfig] = None,
    precomputed_hypers: Optional[Union[str, dict]] = None,
    init_hypers: Optional[dict] = None,
    stats: Optional[list] = None,
    device: Union[str, torch.device] = "cuda",
    cell_sharding=None,
) -> DailyResult:
    """One daily interpolated field with uncertainty, on ``device``: the wave
    of one day (``pipeline.multiday.interpolate_days``).

    Args:
      ds: season dataset (``data.reader.read_freeboard_season`` or synthetic).
      day: start index of the T-day window; the interpolated date is
        ``ds.dates[day + T//2]`` (reference ``:211,216``).
      prior_mean: scalar prior mean (``data.prior.constant_fyi_prior``) or a
        (G, G) field whose NaN cells fall back to its finite mean.
      config: None is ``DailyConfig()`` built at this call, so environment
        knobs set after import take effect.
      precomputed_hypers: the QUICKLOOK path (``GPR3D(opt=False)``): (G, G)
        hyperparameter fields as :func:`load_hypers` takes them. Pass 1 and
        the smoothing are skipped; every cell is predicted once.
      init_hypers: optional per-cell INITIALIZATION fields (a dict as
        ``precomputed_hypers``, linear space): cells whose values are finite
        start pass 1 from them instead of the reference x0, newly active
        cells from the nearest such cell, and the subsample cascade and the
        spatial seeding are skipped. The optimization still runs to the same
        tolerances: this changes the path, not the target.
      stats: optional list; one dict per stage is appended
        ({stage, n, cells, wall_s, iters_sum, ...}; stages ``seed:cascade``,
        ``seed:opt``, ``cascade``, ``opt``, ``predict``, ``smooth``,
        ``pass2``). Under ``cell_sharding`` the shards' entries of a stage
        are merged into one, with ``shards``.
      cell_sharding: a ``parallel.mesh.CellSharding``: every bucket's rows
        are split over its devices, one host thread a shard, and the
        results gathered in row order; its devices replace ``device``. The
        results are the unsharded run's.

    Each predict logs one INFO record with args ``(N, cells, tile rows,
    seconds)`` per bucket (sharded: a tuple of each shard's tile rows); the
    seconds end with the bucket's last results on the host. Each stage logs
    one INFO record ``stage {...}``.
    """
    from optimalinterpolation_tpu_torch.pipeline.multiday import interpolate_days  # imports this

    return interpolate_days(
        ds, [day], [prior_mean], config,
        init_hypers=None if init_hypers is None else [init_hypers],
        precomputed_hypers=precomputed_hypers, stats=stats, device=device,
        cell_sharding=cell_sharding,
    )[0]
