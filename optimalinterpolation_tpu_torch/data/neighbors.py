"""Fixed-radius neighborhood gathering into padded, bucketed batches.

The reference finds each cell's training set with
``cKDTree.query_ball_point(r=300 km)`` and solves one ragged GP per cell
(``GPR_CS2S3.py:159-161,246``). Batched kernels need static shapes, so this
module converts the ragged neighborhoods into a small number of fixed-size
*buckets*: each active cell is assigned to the smallest bucket size >= its
neighbor count, and every bucket becomes one padded (B, N, 3) / (B, N) batch
that the batched GP consumes directly. Host-side numpy on SciPy's kd-tree.

Copy of ``optimalinterpolation_tpu/data/neighbors.py`` on its kd-tree path
only, kept until the JAX package's ``__init__`` is lazy (importing any
module of it imports jax today). The JAX package's C++ grid hash returns the
same neighbor sets; only the order within a row may differ.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
from scipy.spatial import cKDTree

from optimalinterpolation_tpu_torch.data.window import TrainingVectors

__all__ = [
    "NeighborhoodBatch",
    "gather_neighborhoods",
    "bucketize_counts",
    "DEFAULT_BUCKETS",
]

# The production bucket menu (optimalinterpolation_tpu/data/neighbors.py:57):
# cells with <= 512 neighbors fold into the 512 bucket.
DEFAULT_BUCKETS = (512, 1024, 2048, 4096)


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


def gather_neighborhoods(
    train: TrainingVectors,
    cells_xy: np.ndarray,  # (M, 2) active-cell coordinates
    t_star: float,  # prediction day within the window (T_mid)
    radius_m: float,
    buckets: Iterable[int] = DEFAULT_BUCKETS,
    batch_multiple: int = 8,
    dtype=np.float32,
) -> list[NeighborhoodBatch]:
    """Bucketed padded neighborhoods for every active cell.

    Cells with more neighbors than the largest bucket keep their *nearest*
    ``max(buckets)`` points. ``batch_multiple`` pads each bucket's cell
    count; padding rows have ``mask == 0`` and ``cell_index == -1`` and are
    dropped at scatter time.
    """
    buckets = sorted(set(int(b) for b in buckets))
    neighbor_lists = cKDTree(train.xy).query_ball_point(cells_xy, r=radius_m)
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
        bx = np.zeros((b_pad, cap, 3), dtype=dtype)
        bz = np.zeros((b_pad, cap), dtype=dtype)
        bm = np.zeros((b_pad, cap), dtype=dtype)
        bxs = np.zeros((b_pad, 3), dtype=dtype)
        bidx = np.full((b_pad,), -1, dtype=np.int64)
        for r, cell in enumerate(rows):
            ids = neighbor_lists[cell]
            if len(ids) > cap:  # oversize fallback: keep nearest points
                d = np.linalg.norm(train.xy[ids] - cells_xy[cell], axis=1)
                ids = [ids[i] for i in np.argsort(d)[:cap]]
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
