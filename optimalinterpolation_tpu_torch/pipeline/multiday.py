"""Wave-parallel multi-day interpolation: many days as one stacked problem.

PyTorch counterpart of ``optimalinterpolation_tpu/pipeline/multiday.py``.
The reference runs one day per ``mpirun`` job (``GPR_CS2S3.py:336``). Here a
day is more cells: every active cell of every day of a WAVE is an
independent GP over its own 9-day window, so the wave's cells go into the
same fixed-capacity buckets the single day uses, one bucket per capacity
for the whole wave. The fit and the predicts launch over the combined rows,
and the results scatter back into per-day grids for each day's smoothing
and second predict.

A wave launches fewer, fuller kernels than its days one by one: the few-row
line-search launches at the end of each lockstep fit are shared by the
wave's days. A cell's result does not depend on the rows beside it, so a
wave gives each day what ``pipeline.daily.interpolate_daily`` gives it
(``tests/test_torch_multiday.py``), except where valid points are shuffled
for a subsample: one ``default_rng(0)`` permutation per row over the
combined bucket, as the JAX package draws them. Day-to-day chaining composes
with waves through strided membership (``pipeline.season``).

The day's own helpers do the work (``pipeline.daily``: ``_plan_fit``,
``_fit_rows``, ``_fit_adam``, ``_predict_bucket``, ``_smooth_fields``,
``_stage``), on ``device`` or, with ``cell_sharding``
(``parallel.mesh.CellSharding``), on contiguous row ranges of each bucket,
one host thread a device; the shards' results are gathered in row order and
their stage entries merged (:func:`_merge_stages`). This is also the single
day's flow: ``interpolate_daily`` is the wave of one day, whose combined
buckets are the day's own.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Optional, Sequence, Union

import numpy as np
import torch

from optimalinterpolation_tpu_torch.data.neighbors import NeighborhoodBatch, gather_neighborhoods
from optimalinterpolation_tpu_torch.data.reader import ObsDataset
from optimalinterpolation_tpu_torch.data.regrid import nearest_fill
from optimalinterpolation_tpu_torch.data.window import flatten_window
from optimalinterpolation_tpu_torch.models import exact_gp
from optimalinterpolation_tpu_torch.pipeline.daily import (
    HYPER_NAMES,
    DailyConfig,
    DailyResult,
    _filled_init,
    _fit_adam,
    _fit_rows,
    _log_rows,
    _plan_fit,
    _predict_bucket,
    _prior_at_cells,
    _prior_rows,
    _record,
    _row_view,
    _ShardStats,
    _shuffle_for_adam,
    _smooth_fields,
    _stage,
    load_hypers,
    logger,
)

__all__ = ["interpolate_days"]


@dataclasses.dataclass
class _DayCtx:
    date: str
    sie_day: np.ndarray
    active_ij: tuple
    batches: list
    grids: dict  # field name -> (G, G) array


def _day_ctx(ds: ObsDataset, day: int, cfg: DailyConfig, dtype,
             sie_override: Optional[np.ndarray] = None) -> _DayCtx:
    """One day's window, active cells and neighborhood buckets, and empty
    output grids. ``sie_override`` replaces the season's ice mask (the seed
    sublattice)."""
    sie_day = (sie_override if sie_override is not None else ds.sie)[:, :, day + cfg.t_mid]
    train = flatten_window(ds.obs[:, :, :, day : day + cfg.window_days], ds.x, ds.y)
    active_ij = np.nonzero(np.isfinite(sie_day))
    cells_xy = np.stack([ds.x[active_ij], ds.y[active_ij]], axis=1)
    batches = gather_neighborhoods(
        train, cells_xy, t_star=float(cfg.t_mid), radius_m=cfg.radius_km * 1000.0,
        buckets=cfg.buckets, batch_multiple=cfg.batch_multiple, dtype=dtype,
    )
    grids = {
        name: np.full(sie_day.shape, np.nan)
        for name in ("interp", "interp_error", "lZ", *HYPER_NAMES, "interp_smth",
                     "interp_error_smth")
    }
    return _DayCtx(ds.dates[day + cfg.t_mid], sie_day, active_ij, batches, grids)


def _offsets(ctxs) -> np.ndarray:
    """Start of each day's cells in the wave-global active-cell list."""
    return np.concatenate([[0], np.cumsum([c.active_ij[0].size for c in ctxs])]).astype(np.int64)


def _prior_global(ctxs, priors) -> tuple[np.ndarray, float]:
    """Wave-global per-active-cell prior vector (aligned with the offsets
    :func:`_concat_buckets` uses) from per-day scalars and/or (G, G) fields,
    plus the fill scalar of padded bucket rows."""
    vals, fills = [], []
    for c, p in zip(ctxs, priors):
        v, f = _prior_at_cells(p, c.sie_day.shape, c.active_ij)
        vals.append(v)
        fills.append(f)
    return np.concatenate(vals), float(np.mean(fills))


def _per_capacity(ctxs) -> dict:
    """capacity -> [(day position, bucket)], days in wave order."""
    per_cap = defaultdict(list)
    for dpos, c in enumerate(ctxs):
        for b in c.batches:
            per_cap[b.capacity].append((dpos, b))
    return per_cap


def _concat_buckets(items: Sequence[tuple[int, NeighborhoodBatch]], offsets: np.ndarray,
                    batch_multiple: int):
    """Stack same-capacity buckets from several days into one bucket.

    Per-day padding rows are dropped and the combined bucket padded again,
    so real rows sit first, in wave order. Returns ``(batch, day_of_row)``
    with cell_index remapped into the wave-global active-cell list.

    A bucket of the wave's first day alone is returned as it is (no copy):
    ``gather_neighborhoods`` already puts its real rows first and pads them
    to the batch multiple. So a one-day wave fits, shuffles and predicts the
    day's own arrays, and its pass 2 sees the points in the order pass 1
    left them, as the JAX package's single day does."""
    if len(items) == 1 and offsets[items[0][0]] == 0:
        dpos, b = items[0]
        return b, np.full(len(b), dpos, np.int64)
    xs, zs, ms, xss, idxs, dayr = [], [], [], [], [], []
    for dpos, b in items:
        real = b.cell_index >= 0
        xs.append(b.x[real])
        zs.append(b.z[real])
        ms.append(b.mask[real])
        xss.append(b.xstar[real])
        idxs.append(b.cell_index[real] + offsets[dpos])
        dayr.append(np.full(int(real.sum()), dpos, np.int64))
    x, z, m, xst = (np.concatenate(a) for a in (xs, zs, ms, xss))
    idx, day_of_row = np.concatenate(idxs), np.concatenate(dayr)
    n_real = x.shape[0]
    pad = (-n_real) % batch_multiple
    if pad:
        def padded(a):
            return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

        x, z, m, xst = (padded(a) for a in (x, z, m, xst))
        idx = np.concatenate([idx, np.full(pad, -1, np.int64)])
        day_of_row = np.concatenate([day_of_row, np.zeros(pad, np.int64)])
    batch = NeighborhoodBatch(x=x, z=z, mask=m, xstar=xst, cell_index=idx, n_valid_cells=n_real)
    return batch, day_of_row


def _scatter_global(field: str, ctxs, offsets, cell_idx, values) -> None:
    """Write bucket rows (skipping padding) into their days' grids."""
    real = cell_idx >= 0
    gidx = cell_idx[real]
    vals = np.asarray(values)[real]
    day = np.searchsorted(offsets, gidx, side="right") - 1
    local = gidx - offsets[day]
    for dpos in np.unique(day):
        sel = day == dpos
        c = ctxs[dpos]
        c.grids[field][c.active_ij[0][local[sel]], c.active_ij[1][local[sel]]] = vals[sel]


def _on_shards(sharding, device, n_rows: int, batch_multiple: int, stats, fn) -> list:
    """``fn(rows, device, stats)`` over a bucket's ``n_rows`` rows: once on
    ``device`` where ``sharding`` is None, else once a shard through
    ``sharding.map``, whose shards' stage entries are merged into
    ``stats``. Returns the results in row order."""
    if sharding is None:
        return [fn(slice(0, n_rows), device, stats)]

    def shard(rows, dev):
        entries = _ShardStats()
        return fn(rows, dev, entries), entries

    out = sharding.map(n_rows, shard, batch_multiple)
    _merge_stages(stats, [entries for _, entries in out])
    return [result for result, _ in out]


def _merge_stages(stats, shard_entries: list) -> None:
    """One entry a bucket stage, as the JAX package gives it, from the
    shards' entries of the stage (matched by stage and N): cells,
    iterations and converged cells summed, the longest wall, and the number
    of ``shards`` that ran it (a shard whose cascade drained has no entry
    for the later stages). Cascade stages first, by N, then the rest."""
    merged = {}
    for entries in shard_entries:
        for e in entries:
            m = merged.get((e["stage"], e["n"]))
            if m is None:
                merged[(e["stage"], e["n"])] = {**e, "shards": 1}
                continue
            for key in ("cells", "iters_sum", "converged"):
                if key in e:
                    m[key] += e[key]
            m["wall_s"] = max(m["wall_s"], e["wall_s"])
            m["shards"] += 1
    for e in sorted(merged.values(), key=lambda e: (not e["stage"].endswith("cascade"), e["n"])):
        _record(stats, e)


def _predict_into(fields, ctxs, offsets, full_b, lh_rows, prior_cells, prior_fill, cfg, dtype,
                  device, sharding, stats, stage) -> None:
    """Predict a combined bucket (over the shards of ``sharding``, where
    given) and scatter (mean, std[, lZ]) into ``fields``; one INFO record
    ``(N, cells, tile rows, seconds)`` and one stage entry."""
    t0 = time.perf_counter()
    parts = _on_shards(
        sharding, device, len(full_b), cfg.batch_multiple, None,
        lambda rows, dev, _: _predict_bucket(_row_view(full_b, rows), lh_rows[rows],
                                             prior_cells, prior_fill, cfg, dtype, dev),
    )
    out = np.concatenate([o for o, _ in parts], axis=1)
    for field, values in zip(fields, out):
        _scatter_global(field, ctxs, offsets, full_b.cell_index, values)
    secs = time.perf_counter() - t0
    if sharding is None:
        logger.info("bucket N=%d: %d cells in %d-row tiles, %.3f s",
                    full_b.capacity, full_b.n_valid_cells, parts[0][1], secs)
        _stage(stats, stage, full_b.capacity, len(full_b), t0)
    else:
        logger.info("bucket N=%d: %d cells in %s-row tiles (one a shard), %.3f s",
                    full_b.capacity, full_b.n_valid_cells, tuple(t for _, t in parts), secs)
        _stage(stats, stage, full_b.capacity, len(full_b), t0, shards=len(parts))


def _pass1(ctxs: list, priors: Sequence, grid_res_m: float, cfg: DailyConfig, opt_cfg, dtype,
           device, sharding, stats, init_fields: Optional[list], seed_init: bool,
           hypers_only: bool) -> None:
    """Fit (and unless ``hypers_only``, predict) every capacity's combined
    bucket; scatters into the days' grids. Stage names carry ``seed:``
    where ``hypers_only`` (``daily._plan_fit`` adds it)."""
    offsets = _offsets(ctxs)
    prior_cells, prior_fill = _prior_global(ctxs, priors)
    x0 = exact_gp.HYPER_INIT_LOG(grid_res_m, dtype=torch.float64).numpy()
    init_global = None
    if init_fields is not None and any(f is not None for f in init_fields):
        # (sum M_d, 5) linear space; NaN rows (and whole days without a
        # chain, as after a gap in a resumed season) fall back to x0.
        init_global = np.concatenate([
            np.full((c.active_ij[0].size, 5), np.nan) if f is None
            else np.stack([np.asarray(f[n])[c.active_ij] for n in HYPER_NAMES], axis=1)
            for c, f in zip(ctxs, init_fields)
        ])
    per_cap = _per_capacity(ctxs)
    for capacity in sorted(per_cap):
        full_b, _ = _concat_buckets(per_cap[capacity], offsets, cfg.batch_multiple)
        prior_rows = _prior_rows(prior_cells, prior_fill, full_b.cell_index, dtype)
        # Whole-bucket decisions (and the shuffle) first, then the rows.
        if opt_cfg.method == "adam":  # from x0 at full capacity
            _shuffle_for_adam(full_b, cfg, opt_cfg)

            def fit(rows, dev, entries):
                return _fit_adam(_row_view(full_b, rows), x0, prior_rows[rows], cfg, opt_cfg,
                                 dtype, dev, entries)
        else:
            plan = _plan_fit(full_b, x0, init_global, cfg, opt_cfg, dtype,
                             seed_init=seed_init, hypers_only=hypers_only)

            def fit(rows, dev, entries):
                return _fit_rows(_row_view(full_b, rows), plan.h0[rows], prior_rows[rows], plan,
                                 cfg, opt_cfg, dtype, dev, entries)
        lh_all = np.concatenate(
            _on_shards(sharding, device, len(full_b), cfg.batch_multiple, stats, fit))
        hyp = np.exp(lh_all.astype(np.float64))
        for hi, name in enumerate(HYPER_NAMES):
            _scatter_global(name, ctxs, offsets, full_b.cell_index, hyp[:, hi])
        if not hypers_only:
            _predict_into(("interp", "interp_error", "lZ"), ctxs, offsets, full_b, lh_all,
                          prior_cells, prior_fill, cfg, dtype, device, sharding, stats,
                          "predict")


def interpolate_days(
    ds: ObsDataset,
    days: Sequence[int],
    priors: Sequence,
    config: Optional[DailyConfig] = None,
    init_hypers: Optional[Sequence[Optional[dict]]] = None,
    precomputed_hypers: Optional[Union[str, dict]] = None,
    stats: Optional[list] = None,
    device: Union[str, torch.device] = "cuda",
    cell_sharding=None,
) -> list[DailyResult]:
    """One WAVE: several days interpolated as one stacked cell batch, on
    ``device`` or over the shards of ``cell_sharding``.

    Args:
      days: window START indices (the date of entry i is
        ``ds.dates[days[i] + T//2]``).
      priors: per-day prior means aligned with ``days``, scalars and/or
        (G, G) fields (see ``interpolate_daily``'s ``prior_mean``).
      config: None is ``DailyConfig()`` built at this call.
      init_hypers: optional per-day warm-start fields (None for a day
        without one), as ``interpolate_daily`` takes them: cells start from
        them (newly active cells from the nearest one), and the seed pass
        and the cascade are skipped.
      precomputed_hypers: the QUICKLOOK path: one set of (G, G) hyper
        fields for every day of the wave (as ``daily.load_hypers`` takes
        them); the fit and the smoothing are skipped and the wave is one
        combined predict.
      stats: optional list; one dict per stage, as ``interpolate_daily``
        appends them (a wave's stages cover all its days).
      cell_sharding: a ``parallel.mesh.CellSharding``, as
        ``interpolate_daily`` takes it: every combined bucket's rows split
        over its devices, which replace ``device``.

    With ``config.opt.method == "adam"`` a wave holds one day (as in the
    JAX package; more raise ValueError), and the day's fit is
    ``daily._fit_adam``: no seed pass, no cascade, ``init_hypers`` unused.

    Each predicted bucket logs one INFO record with args ``(N, cells, tile
    rows, seconds)``; each stage one INFO record ``stage {...}``.
    """
    cfg = config if config is not None else DailyConfig()
    device = torch.device(device)
    dtype = np.dtype(cfg.dtype)
    grid_res_m = ds.grid_res_km * 1000.0
    priors = list(priors)
    if len(priors) != len(days):
        raise ValueError("priors must align with days")
    opt_cfg = dataclasses.replace(cfg.opt, kind=cfg.kind, jitter=cfg.jitter)
    if opt_cfg.method != "lbfgs" and len(days) > 1:  # multiday.py:194-195
        raise ValueError("interpolate_days supports method='lbfgs' only for a wave of "
                         "more than one day")

    ctxs = [_day_ctx(ds, d, cfg, dtype) for d in days]

    if precomputed_hypers is not None:
        hypers = load_hypers(precomputed_hypers)
        for name, field in hypers.items():
            if field.shape != ds.sie.shape[:2]:
                raise ValueError(f"{name} field shape {field.shape} != grid shape "
                                 f"{ds.sie.shape[:2]}")
        return _pass2_assemble(cfg, ctxs, [hypers] * len(ctxs), priors, dtype, device,
                               cell_sharding, stats, quicklook=True)

    init_fields = None
    if init_hypers is not None:
        init_fields = [None if f is None else _filled_init(f, ds, c.sie_day)
                       for f, c in zip(init_hypers, ctxs)]
    seed_init = False
    if cfg.spatial_seed_stride > 1 and init_fields is None and opt_cfg.method == "lbfgs":
        # Phase A, combined over the wave: cold-fit each day's seed
        # sublattice, hypers only; phase B starts every day's cells from its
        # nearest seed (DailyConfig.spatial_seed_stride). At least 8 seeds
        # a day, or the fill means little.
        s = cfg.spatial_seed_stride
        keep = np.zeros(ds.sie.shape[:2], bool)
        keep[s // 2 :: s, s // 2 :: s] = True
        if min(int((keep & np.isfinite(c.sie_day)).sum()) for c in ctxs) >= 8:
            sie_seed = ds.sie.copy()
            sie_seed[~keep] = np.nan
            cfg = dataclasses.replace(cfg, spatial_seed_stride=0)
            seed_ctxs = [_day_ctx(ds, d, cfg, dtype, sie_override=sie_seed) for d in days]
            _pass1(seed_ctxs, priors, grid_res_m, cfg, opt_cfg, dtype, device, cell_sharding,
                   stats, None, seed_init=False, hypers_only=True)
            init_fields = [{n: nearest_fill(sc.grids[n], ds.x, ds.y) for n in HYPER_NAMES}
                           for sc in seed_ctxs]
            seed_init = True

    _pass1(ctxs, priors, grid_res_m, cfg, opt_cfg, dtype, device, cell_sharding, stats,
           init_fields, seed_init=seed_init, hypers_only=False)

    # ---- per-day smoothing (float64, host) ---------------------------------
    t_smooth = time.perf_counter()
    radius_m = cfg.radius_km * 1000.0
    vmaxes = {
        "ell_x": 2.0 * radius_m, "ell_y": 2.0 * radius_m, "ell_t": float(cfg.window_days),
        "sf2": cfg.sf2_vmax, "sn2": cfg.sn2_vmax,
    }
    std = cfg.smoothing_std(ds.grid_res_km)
    smth = [_smooth_fields(c.grids, vmaxes, c.sie_day, std) for c in ctxs]
    _stage(stats, "smooth", int(ds.sie.shape[0]), 5 * len(ctxs), t_smooth)

    return _pass2_assemble(cfg, ctxs, smth, priors, dtype, device, cell_sharding, stats,
                           quicklook=False)


def _pass2_assemble(cfg: DailyConfig, ctxs, smth, priors, dtype, device, sharding, stats,
                    quicklook: bool) -> list[DailyResult]:
    """Combined fixed-hyper predict over all days' buckets, then the
    results. ``quicklook``: no pass-1 grids exist, so the predictions double
    as the unsmoothed outputs and lZ comes from this predict (as
    interpolate_daily's quicklook branch)."""
    offsets = _offsets(ctxs)
    prior_cells, prior_fill = _prior_global(ctxs, priors)
    smth_at_cells = np.concatenate([
        np.stack([h[n][c.active_ij] for n in HYPER_NAMES], axis=1) for h, c in zip(smth, ctxs)
    ])
    fields = ("interp_smth", "interp_error_smth") + (("lZ",) if quicklook else ())
    per_cap = _per_capacity(ctxs)
    for capacity in sorted(per_cap):
        full_b, _ = _concat_buckets(per_cap[capacity], offsets, cfg.batch_multiple)
        _predict_into(fields, ctxs, offsets, full_b,
                      _log_rows(smth_at_cells, full_b.cell_index, dtype),
                      prior_cells, prior_fill, cfg, dtype, device, sharding, stats, "pass2")

    return [
        DailyResult(
            date=c.date,
            interp=c.grids["interp_smth"].copy() if quicklook else c.grids["interp"],
            interp_error=(c.grids["interp_error_smth"].copy() if quicklook
                          else c.grids["interp_error"]),
            lZ=c.grids["lZ"],
            hypers=h if quicklook else {n: c.grids[n] for n in HYPER_NAMES},
            hypers_smth=h,
            interp_smth=c.grids["interp_smth"],
            interp_error_smth=c.grids["interp_error_smth"],
        )
        for h, c in zip(smth, ctxs)
    ]
