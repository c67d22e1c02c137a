"""Masked/padded dense linear algebra for batched local GPs.

PyTorch counterpart of ``optimalinterpolation_tpu/ops/linalg.py``. Ragged
per-cell problems are padded to a common N with the identity-padding
construction

  A = (m m^T) .* K  +  sn2 * diag(m)  +  diag(1 - m),

whose factorization restricted to the valid rows equals that of the valid
block (padded rows and columns are exactly e_i), so log det and masked solves
are unchanged by padding.

Failure policy: the reference emits a NaN cell when LAPACK raises
(``GPR_CS2S3.py:139-140,187-191``); here :func:`masked_cholesky` returns an
``ok`` flag that callers turn into NaN outputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["masked_psd_matrix", "masked_cholesky", "tri_solve", "chol_solve", "CholResult"]


def masked_psd_matrix(k: torch.Tensor, sn2, mask: torch.Tensor, jitter=0.0) -> torch.Tensor:
    """Add sn2*diag(m) + jitter*diag(m) + diag(1-m) to ``k`` IN PLACE and
    return it (``k`` must already have masked rows/cols zeroed, see
    ``kernels.kernel_matrix(mask=...)``; in place because at N = 4096 every
    (N, N) copy is tens of MB per cell). ``sn2`` and ``jitter`` are scalars
    or per-batch tensors; ``jitter`` stabilizes valid rows only."""
    m = mask.to(k.dtype)
    diag = torch.as_tensor(sn2 + jitter, dtype=k.dtype, device=k.device)[..., None] * m + (1.0 - m)
    k.diagonal(dim1=-2, dim2=-1).add_(diag)
    return k


class CholResult(NamedTuple):
    chol: torch.Tensor  # (..., n, n) lower-triangular factor (garbage if not ok)
    ok: torch.Tensor  # (...) bool: factorization succeeded


def masked_cholesky(a: torch.Tensor) -> CholResult:
    """Lower Cholesky of a padded PSD matrix, with a success flag.

    ``ok`` is False when the factorization failed or any diagonal entry of
    the factor is not finite (``linalg.py:73``): ``cholesky_ex``'s ``info``
    alone does not flag every NaN input, and NaN hypers must give NaN cells.
    """
    chol, info = torch.linalg.cholesky_ex(a)
    diag_ok = torch.isfinite(chol.diagonal(dim1=-2, dim2=-1)).all(dim=-1)
    return CholResult(chol, (info == 0) & diag_ok)


def tri_solve(l: torch.Tensor, b: torch.Tensor, *, trans: bool = False) -> torch.Tensor:
    """Solve L x = b (or L^T x = b) with L lower-triangular; b is (..., n, k)."""
    if trans:
        return torch.linalg.solve_triangular(l.mT, b, upper=True)
    return torch.linalg.solve_triangular(l, b, upper=False)


def chol_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b, the reference's double ``np.linalg.solve``
    (``GPR_CS2S3.py:127``)."""
    return tri_solve(l, tri_solve(l, b), trans=True)
