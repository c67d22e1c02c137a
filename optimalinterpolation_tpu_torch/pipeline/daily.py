"""Quicklook daily pan-Arctic interpolation (reference layer L3, predict pass).

PyTorch counterpart of the ``precomputed_hypers`` path of
``optimalinterpolation_tpu/pipeline/daily.py::interpolate_daily``: the
reference's quicklook production scheme ``GPR3D(opt=False)``
(``GPR_CS2S3.py:169-186``; ``QuickLook Data/README.txt``), which predicts
every active cell once with given (G, G) hyperparameter fields. It produced
the shipped quicklook NetCDFs and is the pass-2 half of the full two-pass day.

Cells are gathered into fixed-size neighborhood buckets (``data.neighbors``);
each bucket runs in chunks of one fixed tile size through
``models.exact_gp_batch.predict_batch`` (K2 for N <= 1024, the blocked path
with K1 above), and each chunk's results come back to the host in one copy.

Output keys replicate the reference result dict (``:290-307,333-334``).
Pass 1 (per-cell hyperparameter optimization) and the smoothing between the
passes are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from optimalinterpolation_tpu_torch.data.neighbors import (
    DEFAULT_BUCKETS,
    NeighborhoodBatch,
    gather_neighborhoods,
)
from optimalinterpolation_tpu_torch.data.reader import ObsDataset
from optimalinterpolation_tpu_torch.data.window import flatten_window
from optimalinterpolation_tpu_torch.models.exact_gp_batch import predict_batch
from optimalinterpolation_tpu_torch.ops import fused_gp
from optimalinterpolation_tpu_torch.ops.kernels import Kernel

__all__ = ["HYPER_NAMES", "DailyConfig", "DailyResult", "load_hypers", "interpolate_daily"]

HYPER_NAMES = ("ell_x", "ell_y", "ell_t", "sf2", "sn2")

logger = logging.getLogger(__name__)

# Live (N, N) buffers per cell of the blocked path: A and its factor, plus
# the block products' temporaries.
_BLOCKED_BUFFERS = 2.5


@dataclasses.dataclass(frozen=True)
class DailyConfig:
    """The knobs of the quicklook path (the reference hardcodes them as
    module globals, ``GPR_CS2S3.py:201-217``)."""

    window_days: int = 9  # T
    radius_km: float = 300.0
    kind: Kernel = Kernel.MATERN32
    buckets: Sequence[int] = DEFAULT_BUCKETS
    batch_multiple: int = 8
    dtype: str = "float32"
    jitter: float = 0.0
    # Device bytes one chunk of cells may hold in (N, N)-sized working
    # memory: K2's (N, N) + (N, 128) scratch per cell, or _BLOCKED_BUFFERS
    # (N, N) buffers on the blocked path. 16 GB leaves the rest of an 80 GB
    # card to the kernel-matrix build's temporaries and the allocator.
    max_chunk_bytes: float = 16e9

    @property
    def t_mid(self) -> int:
        return self.window_days // 2


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


def _scatter(grid: np.ndarray, active_ij, cell_idx: np.ndarray, values: np.ndarray):
    """Write bucket rows (skipping batch padding) back onto the 2-D grid."""
    real = cell_idx >= 0
    grid[active_ij[0][cell_idx[real]], active_ij[1][cell_idx[real]]] = values[real]


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


def _chunk_rows(capacity: int, n_rows: int, cfg: DailyConfig, itemsize: int) -> int:
    """One launch tile per bucket: the fewest chunks the byte budget allows
    (at least ``batch_multiple`` rows), split evenly, in multiples of
    ``batch_multiple``."""
    if fused_gp.supported(capacity):
        per_row = (capacity * capacity + capacity * fused_gp.BLK) * itemsize
    else:
        per_row = _BLOCKED_BUFFERS * capacity * capacity * itemsize
    bm = cfg.batch_multiple
    cap = max(bm, int(cfg.max_chunk_bytes // per_row) // bm * bm)
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


def interpolate_daily(
    ds: ObsDataset,
    day: int,
    prior_mean,
    config: DailyConfig = DailyConfig(),
    precomputed_hypers: Optional[Union[str, dict]] = None,
    device: Union[str, torch.device] = "cuda",
) -> DailyResult:
    """One daily interpolated field with uncertainty, on ``device``.

    Args:
      ds: season dataset (``data.reader.read_freeboard_season`` or synthetic).
      day: start index of the T-day window; the interpolated date is
        ``ds.dates[day + T//2]`` (reference ``:211,216``).
      prior_mean: scalar prior mean (``data.prior.constant_fyi_prior``) or a
        (G, G) field whose NaN cells fall back to its finite mean.
      precomputed_hypers: the quicklook hyperparameter fields, as
        :func:`load_hypers` takes them. Required: without it the flow needs
        pass 1, which is not ported yet.

    Each bucket logs one INFO record with args ``(N, cells, tile rows,
    seconds)``; the seconds end with the bucket's last results on the host.
    """
    if precomputed_hypers is None:
        raise NotImplementedError(
            "pass 1 (per-cell hyperparameter optimization, models/optimizer.py "
            "of the JAX package) is not ported yet: pass precomputed_hypers"
        )
    cfg = config
    device = torch.device(device)
    dtype = np.dtype(cfg.dtype)
    date = ds.dates[day + cfg.t_mid]
    sie_day = ds.sie[:, :, day + cfg.t_mid]
    shape = sie_day.shape
    hypers = load_hypers(precomputed_hypers)
    for name, field in hypers.items():
        if field.shape != shape:
            raise ValueError(f"{name} field shape {field.shape} != grid shape {shape}")

    train = flatten_window(ds.obs[:, :, :, day : day + cfg.window_days], ds.x, ds.y)
    active_ij = np.nonzero(np.isfinite(sie_day))
    cells_xy = np.stack([ds.x[active_ij], ds.y[active_ij]], axis=1)
    prior_cells, prior_fill = _prior_at_cells(prior_mean, shape, active_ij)
    batches = gather_neighborhoods(
        train, cells_xy, t_star=float(cfg.t_mid), radius_m=cfg.radius_km * 1000.0,
        buckets=cfg.buckets, batch_multiple=cfg.batch_multiple, dtype=dtype,
    )
    # Per-cell log hypers, as daily.py:824 computes them (NaN stays NaN).
    log_cells = np.log(np.maximum(
        np.stack([hypers[k][active_ij] for k in HYPER_NAMES], axis=1), 1e-30
    ))

    interp = np.full(shape, np.nan)
    interp_error = np.full(shape, np.nan)
    lz_grid = np.full(shape, np.nan)
    for full_b in batches:
        t0 = time.perf_counter()
        tile = _chunk_rows(full_b.capacity, len(full_b), cfg, dtype.itemsize)
        for b in _chunks_of(full_b, tile):
            real = b.cell_index >= 0
            lh = np.zeros((len(b), 5), dtype=dtype)
            lh[real] = log_cells[b.cell_index[real]]
            mean = _prior_rows(prior_cells, prior_fill, b.cell_index, dtype)
            args = [torch.from_numpy(a).to(device) for a in (lh, b.x, b.z, b.xstar, b.mask, mean)]
            pred = predict_batch(*args, kind=cfg.kind, jitter=cfg.jitter)
            out = torch.stack([pred.mean, pred.std, pred.lZ]).cpu().numpy()  # one copy
            _scatter(interp, active_ij, b.cell_index, out[0])
            _scatter(interp_error, active_ij, b.cell_index, out[1])
            _scatter(lz_grid, active_ij, b.cell_index, out[2])
        logger.info(
            "bucket N=%d: %d cells in %d-row tiles, %.3f s",
            full_b.capacity, full_b.n_valid_cells, tile, time.perf_counter() - t0,
        )
    return DailyResult(
        date=date,
        interp=interp.copy(),
        interp_error=interp_error.copy(),
        lZ=lz_grid,
        hypers=hypers,
        hypers_smth=hypers,
        interp_smth=interp,
        interp_error_smth=interp_error,
    )
