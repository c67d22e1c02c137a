"""Fixed-radius neighborhood gathering into padded, bucketed batches.

The reference finds each cell's training set with
``cKDTree.query_ball_point(r=300 km)`` and solves one ragged GP per cell
(``GPR_CS2S3.py:159-161,246``). Batched kernels need static shapes, so this
module converts the ragged neighborhoods into a small number of fixed-size
*buckets*: each active cell is assigned to the smallest bucket size >= its
neighbor count, and every bucket becomes one padded (B, N, 3) / (B, N) batch
that the batched GP consumes directly.

Port of ``optimalinterpolation_tpu/data/neighbors.py``. The neighbor search
is the C++ grid hash of ``native`` (the JAX package's, copied), and the
buckets are filled from its CSR lists with array indexing, in chunks of rows,
where the JAX module loops over cells in Python. The arrays are the JAX
gather's, bit for bit. ``_gather_plain`` (SciPy's kd-tree and the JAX
per-cell loop) is the plain version the tests and ``chip_smoke.py`` hold it
against.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional, Sequence

import numpy as np
from scipy.spatial import cKDTree

from optimalinterpolation_tpu_torch import native
from optimalinterpolation_tpu_torch.data.window import TrainingVectors

__all__ = [
    "NeighborhoodBatch",
    "gather_neighborhoods",
    "bucketize_counts",
    "default_buckets",
    "DEFAULT_BUCKETS",
]

# The production bucket menu (optimalinterpolation_tpu/data/neighbors.py:57):
# cells with <= 512 neighbors fold into the 512 bucket.
DEFAULT_BUCKETS = (512, 1024, 2048, 4096)


def default_buckets() -> tuple:
    """The production bucket menu, with 128 and 256 buckets in front where
    ``OI_BUCKET_128`` / ``OI_BUCKET_256`` are set (to anything non-empty):
    thin cells then run at N = 128 / 256 instead of padding to 512
    (``neighbors.py:60-68``). Read at every call, so a knob set after import
    takes effect."""
    return (((128,) if os.environ.get("OI_BUCKET_128") else ())
            + ((256,) if os.environ.get("OI_BUCKET_256") else ())
            + DEFAULT_BUCKETS)


@dataclasses.dataclass
class NeighborhoodBatch:
    """One padded bucket of per-cell GP problems."""

    x: np.ndarray  # (B, N, 3) neighbor coords (x, y, t); zeros in padding
    z: np.ndarray  # (B, N) neighbor observations; zeros in padding
    mask: np.ndarray  # (B, N) 1 = valid neighbor
    xstar: np.ndarray  # (B, 3) the cell's own (x, y, t_mid) test input
    cell_index: np.ndarray  # (B,) index into the caller's active-cell list;
    #                          -1 marks batch-padding rows (mask all zero)
    n_valid_cells: int  # rows < n_valid_cells are real cells

    @property
    def capacity(self) -> int:
        return self.x.shape[1]

    def __len__(self):
        return self.x.shape[0]


def bucketize_counts(counts: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    """Smallest bucket size >= count (clamped to the largest bucket)."""
    buckets = np.asarray(sorted(buckets))
    idx = np.searchsorted(buckets, counts)
    return np.minimum(idx, len(buckets) - 1)


# Neighbor slots filled per chunk of rows: the chunk's index arrays (a few
# int64 arrays of this length) stay near 100 MB. A 25 km day has ~2e7 slots.
_FILL_CHUNK = 1 << 22


def _empty_bucket(b_pad: int, cap: int, dtype):
    return (np.zeros((b_pad, cap, 3), dtype=dtype), np.zeros((b_pad, cap), dtype=dtype),
            np.zeros((b_pad, cap), dtype=dtype), np.zeros((b_pad, 3), dtype=dtype),
            np.full((b_pad,), -1, dtype=np.int64))


def _nearest_cap(train: TrainingVectors, cell_xy: np.ndarray, ids, cap: int):
    """The oversize fallback of the JAX gather: a cell's ``cap`` nearest
    neighbors, in the order of the same ``argsort``."""
    d = np.linalg.norm(train.xy[ids] - cell_xy, axis=1)
    return [ids[i] for i in np.argsort(d)[:cap]]


def gather_neighborhoods(
    train: TrainingVectors,
    cells_xy: np.ndarray,  # (M, 2) active-cell coordinates
    t_star: float,  # prediction day within the window (T_mid)
    radius_m: float,
    buckets: Optional[Iterable[int]] = None,
    batch_multiple: int = 8,
    dtype=np.float32,
) -> list[NeighborhoodBatch]:
    """Bucketed padded neighborhoods for every active cell.

    Cells with more neighbors than the largest bucket keep their *nearest*
    ``max(buckets)`` points. ``buckets`` None is :func:`default_buckets` at
    this call. ``batch_multiple`` pads each bucket's cell count; padding
    rows have ``mask == 0`` and ``cell_index == -1`` and are dropped at
    scatter time. Each row holds its points in ascending index order of
    ``train`` (an oversize row: nearest first).
    """
    if buckets is None:
        buckets = default_buckets()
    buckets = sorted(set(int(b) for b in buckets))
    offsets, flat = native.radius_neighbors(train.xy, cells_xy, radius_m)
    counts = np.diff(offsets)
    which = bucketize_counts(counts, buckets)

    xyt = train.xyt
    z = train.z
    out: list[NeighborhoodBatch] = []
    for bi, cap in enumerate(buckets):
        rows = np.nonzero(which == bi)[0]
        if rows.size == 0:
            continue
        b_real = rows.size
        b_pad = -(-b_real // batch_multiple) * batch_multiple
        bx, bz, bm, bxs, bidx = _empty_bucket(b_pad, cap, dtype)
        bxs[:b_real, :2] = cells_xy[rows]
        bxs[:b_real, 2] = t_star
        bidx[:b_real] = rows
        k = counts[rows]
        fits = np.nonzero(k <= cap)[0]
        # rows whose neighbors fit, in chunks of about _FILL_CHUNK slots:
        # slot j of row r takes flat[offsets[cell] + j], j < k
        ends = np.cumsum(k[fits])
        lo = 0
        while lo < fits.size:
            base = ends[lo - 1] if lo else 0
            hi = max(lo + 1, int(np.searchsorted(ends, base + _FILL_CHUNK, side="right")))
            r = fits[lo:hi]
            kr = k[r]
            slot = np.arange(int(kr.sum())) - np.repeat(np.cumsum(kr) - kr, kr)
            ids = flat[np.repeat(offsets[rows[r]], kr) + slot]
            dst = np.repeat(r * cap, kr) + slot  # into the (B * N) flattened rows
            bx.reshape(-1, 3)[dst] = xyt[ids]
            bz.reshape(-1)[dst] = z[ids]
            bm.reshape(-1)[dst] = 1.0
            lo = hi
        for r in np.nonzero(k > cap)[0]:  # oversize fallback: keep nearest points
            cell = rows[r]
            ids = _nearest_cap(train, cells_xy[cell], flat[offsets[cell]:offsets[cell + 1]], cap)
            bx[r] = xyt[ids]
            bz[r] = z[ids]
            bm[r] = 1.0
        out.append(
            NeighborhoodBatch(
                x=bx, z=bz, mask=bm, xstar=bxs, cell_index=bidx, n_valid_cells=b_real
            )
        )
    return out


def _neighbor_lists_kdtree(train: TrainingVectors, cells_xy: np.ndarray,
                           radius_m: float) -> list:
    """Plain version of the neighbor search: SciPy's kd-tree, one ascending
    list of point indices per cell. It can leave out a point at exactly the
    radius that the grid hash keeps (``<=``): on a 50 km grid at a 450 km
    radius, a few of (0, 450 km); at the production 25 km and 300 km the two
    agree (``chip_smoke.py`` chain phase)."""
    return cKDTree(train.xy).query_ball_point(cells_xy, r=radius_m)


def _gather_plain(
    train: TrainingVectors,
    cells_xy: np.ndarray,
    t_star: float,
    radius_m: float,
    buckets: Optional[Iterable[int]] = None,
    batch_multiple: int = 8,
    dtype=np.float32,
) -> list[NeighborhoodBatch]:
    """Plain version of ``gather_neighborhoods``: the kd-tree lists filled
    into buckets cell by cell, as the JAX package's gather fills them."""
    if buckets is None:
        buckets = default_buckets()
    buckets = sorted(set(int(b) for b in buckets))
    neighbor_lists = _neighbor_lists_kdtree(train, cells_xy, radius_m)
    counts = np.fromiter(
        (len(v) for v in neighbor_lists), dtype=np.int64, count=len(neighbor_lists)
    )
    which = bucketize_counts(counts, buckets)

    xyt = train.xyt
    z = train.z
    out: list[NeighborhoodBatch] = []
    for bi, cap in enumerate(buckets):
        rows = np.nonzero(which == bi)[0]
        if rows.size == 0:
            continue
        b_real = rows.size
        b_pad = -(-b_real // batch_multiple) * batch_multiple
        bx, bz, bm, bxs, bidx = _empty_bucket(b_pad, cap, dtype)
        for r, cell in enumerate(rows):
            ids = neighbor_lists[cell]
            if len(ids) > cap:
                ids = _nearest_cap(train, cells_xy[cell], ids, cap)
            k = len(ids)
            bx[r, :k] = xyt[ids]
            bz[r, :k] = z[ids]
            bm[r, :k] = 1.0
            bxs[r, :2] = cells_xy[cell]
            bxs[r, 2] = t_star
            bidx[r] = cell
        out.append(
            NeighborhoodBatch(
                x=bx, z=bz, mask=bm, xstar=bxs, cell_index=bidx, n_valid_cells=b_real
            )
        )
    return out
