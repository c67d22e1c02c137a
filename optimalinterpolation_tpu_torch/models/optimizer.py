"""Batched marginal-likelihood hyperparameter optimization.

PyTorch counterpart of ``optimalinterpolation_tpu/models/optimizer.py``: the
reference's per-cell ``scipy.optimize.minimize(SMLII, x0, method='CG',
jac=True)`` (``GPR_CS2S3.py:166``) as one lockstep L-BFGS over the five
log-hyperparameters of thousands of cells at once, or, with
``method="adam"``, a fixed number of Adam steps on a cosine-decayed learning
rate (``optimizer.py:546-573``). Every update is a row-wise
``where``, so a cell's trajectory does not depend on which other cells share
its batch, its chunk or its segment; finished cells are frozen while the
slowest finish, and :func:`optimize_mll_chunked` drops them between segments.

The objective is one of four, chosen by :func:`_resolve_backend` as the JAX
package chooses: **K3** (``ops.fused_gp.gp_nll`` / ``gp_nll_and_grad``), the
blocked exact objective (``ops.blocked_gp``, K1 under its Cholesky), the
rank-M Nystrom objective (``ops.nystroem_gp``, K1 under both of its
factorizations) or the plain autograd form of ``models.exact_gp`` (backend
``"xla"``, the name the JAX package gives its plain path). The optimizer's
own arithmetic, on (B, 5) vectors, is plain torch on the device of its
inputs, and the L-BFGS state stays there. JAX's ``lax.while_loop`` becomes a
Python loop whose condition reads from the device which rows are still at
work: one host synchronisation per L-BFGS iteration and one per line-search
step, counted in ``_lbfgs_segment.host_syncs``. The objective is then
evaluated for those rows only, which leaves every cell's trajectory as it
was.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from optimalinterpolation_tpu_torch.models import exact_gp
from optimalinterpolation_tpu_torch.ops import blocked_gp, fused_gp, nystroem_gp
from optimalinterpolation_tpu_torch.ops import kernels as K
from optimalinterpolation_tpu_torch.utils import counters

__all__ = [
    "OptimizeConfig",
    "OptimizeResult",
    "LbfgsState",
    "optimize_mll",
    "optimize_mll_batch",
    "optimize_mll_chunked",
    "lbfgs_state_from_numpy",
    "lbfgs_state_to_numpy",
    "blocked_min_n",
    "routed_nystroem_m",
]


# Deterministic restart offsets in log-hyperparameter space
# [log ell_x, log ell_y, log ell_t, log sf2, log sn2]:
# 0: the reference x0 itself; 1: longer spatial scales; 2: shorter scales +
# more signal; 3: low-noise high-signal corner.
_RESTART_OFFSETS = (
    (0.0, 0.0, 0.0, 0.0, 0.0),
    (1.0, 1.0, 0.7, 0.0, 0.0),
    (-1.0, -1.0, -0.7, 1.0, 0.0),
    (0.5, 0.5, 0.0, 1.5, -1.5),
)


# "auto"'s thresholds, chosen by the rule in _resolve_backend's docstring
# from measurements on an H100 (OptimizeConfig, blocked_min_n).
_NYSTROEM_MIN_N = 2048
_BLOCKED_MIN_N = 2049


@dataclasses.dataclass(frozen=True)
class OptimizeConfig:
    """Knobs of the per-cell MLL optimization (``optimizer.py:44-110``).

    ``ftol_abs``: a cell stops once ``ftol_patience`` consecutive accepted
    steps each improve the NLL by less than ``ftol_abs`` nats; 0 disables.
    ``restarts``: every cell is also optimized from ``_RESTART_OFFSETS`` and
    the best NLL wins; 1 is the reference's single trajectory from x0.
    ``backend``: ``"auto"``, ``"fused"`` (K3; ``"pallas"`` is a synonym, so
    a JAX config carries across), ``"blocked"``, ``"nystroem"`` or ``"xla"``
    (plain autograd objective, any N); see :func:`_resolve_backend`.
    ``nystroem_min_n`` / ``nystroem_m``: under ``"auto"``, problems of
    N >= nystroem_min_n (and N >= 2 nystroem_m) are fitted on the rank-
    ``nystroem_m`` Nystrom objective; 0 disables. ``OI_NYSTROEM_MIN_N``
    overrides the threshold, as in the JAX package.
    ``method``: ``"lbfgs"`` or ``"adam"`` (``max_iters`` steps of Adam at a
    peak learning rate ``adam_lr``, cosine-decayed to 0 over ``max_iters``;
    no stopping rule, no line search).

    The defaults differ from the JAX package's (``nystroem_min_n`` 1024,
    chosen on a v5e). On an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``
    objectives phase, two calls, ``PERF.md``) the rank-512 fit of 1,024
    cells of the 1024 bucket's fine stage took 11.2-13.0 ms a cell against
    K3's 2.3-2.4 ms, so N = 1024 stays on K3; at N = 2048 its estimated
    15.5-25.6 ms a cell beat the blocked objective's 24.9-29.2 ms by more
    than the 10% tie margin, with its quality held (mean float64 exact-NLL
    cost 0.046 nats against the K3 fit, rmse vs the truth 0.04 mm above
    it). A config with the JAX package's values still routes as the JAX
    package routes it.
    """

    method: str = "lbfgs"
    max_iters: int = 60
    grad_tol: float = 1e-4
    ftol_abs: float = 0.0
    ftol_patience: int = 3
    jitter: float = 0.0
    kind: K.Kernel = K.Kernel.MATERN32
    backend: str = "auto"
    nystroem_min_n: int = _NYSTROEM_MIN_N
    nystroem_m: int = 512
    restarts: int = 1
    adam_lr: float = 0.2

    def __post_init__(self):
        if self.method not in ("lbfgs", "adam"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.backend not in ("auto", "xla", "fused", "pallas", "blocked", "nystroem"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.nystroem_m % blocked_gp.BLK != 0:
            raise ValueError("nystroem_m must be a multiple of 128")
        if not 1 <= self.restarts <= len(_RESTART_OFFSETS):
            raise ValueError(f"restarts must be in [1, {len(_RESTART_OFFSETS)}]")


class OptimizeResult(NamedTuple):
    log_hypers: torch.Tensor  # (5,), or (B, 5) from the batched paths
    nll: torch.Tensor  # final negative log marginal likelihood, () or (B,)
    iters: torch.Tensor  # iterations each cell advanced
    converged: torch.Tensor  # gradient tolerance or plateau reached


_LBFGS_HISTORY = 8
_LS_MAX_STEPS = 12
_LS_C1 = 1e-4
# Largest first trial step in log-hyperparameter space: uncapped full L-BFGS
# steps can jump into the degenerate noise-only basin (sf2 -> 0).
_MAX_STEP = 1.0


def _seg_schedule() -> tuple:
    """Leading segment lengths of optimize_mll_chunked's sweeps: warm-started
    stages mostly need 0-4 iterations a cell, with a long tail of stragglers
    that would carry a whole chunk through a full-length first segment.
    ``OI_SEG_SCHEDULE="a,b,..."`` replaces the default ``"1,4"``; read at
    every call (``optimizer.py:744-747``)."""
    return tuple(int(x) for x in os.environ.get("OI_SEG_SCHEDULE", "1,4").split(",") if x)


def blocked_min_n() -> int:
    """Size from which ``"auto"`` prefers the blocked exact objective to K3
    (``OI_BLOCKED_MIN_N`` overrides it, as in the JAX package). The default,
    2049, is above K3's range: on the H100 the blocked value + gradient of
    132 rows at N = 1024 took 24.7-25.2 ms against K3's 5.1 ms (``chip_smoke.py``
    objectives phase, two calls), so the blocked objective takes only the
    sizes K3 does not (the JAX package's default, 512, was measured on a
    v5e)."""
    return int(os.environ.get("OI_BLOCKED_MIN_N", str(_BLOCKED_MIN_N)))


def routed_nystroem_m(config: OptimizeConfig, n: int) -> int:
    """The Nystrom rank a problem of N = ``n`` points is fitted with, 0 for
    an exact objective (``optimizer.py:178-190``): ``config.nystroem_m``
    where the backend is ``"nystroem"``, or where it is ``"auto"`` and
    N >= the threshold (``OI_NYSTROEM_MIN_N`` if set, else
    ``config.nystroem_min_n``; 0 disables) and N >= 2 nystroem_m."""
    if config.backend == "nystroem":
        return config.nystroem_m
    if config.backend != "auto":
        return 0
    env = os.environ.get("OI_NYSTROEM_MIN_N")
    min_n = int(env) if env is not None else config.nystroem_min_n
    if min_n and n >= min_n and n >= 2 * config.nystroem_m:
        return config.nystroem_m
    return 0


def _resolve_backend(config: OptimizeConfig, n: int) -> str:
    """``"nystroem:<M>"``, ``"blocked"``, ``"fused"`` or ``"xla"`` for a
    problem of N = ``n`` points, in the JAX package's precedence
    (``optimizer.py:193-216``): the Nystrom objective where
    :func:`routed_nystroem_m` routes it, then a forced backend, then
    ``"auto"``: the blocked objective for multiples of 128 from
    :func:`blocked_min_n`, K3 where ``fused_gp.supported(n)``, the blocked
    objective for larger multiples of 128, the plain path otherwise. The
    JAX package takes this ``"auto"`` branch on the TPU in float32; the port
    takes it on every device, where the device only decides kernel or twin
    inside each wrapper.

    The defaults follow a rule applied to measurements on the card
    (``chip_smoke.py::_routing_rule``): the fine stage at N = 1024 is fitted
    under each objective from one warm start; at N = 2048 and 4096 a cell's
    fit time is estimated from the evaluations a cell made there times the
    per-row evaluation times at that N. ``nystroem_min_n`` is the smallest
    N in {1024, 2048, 4096} at which the Nystrom fit is faster than the
    exact objective ``"auto"`` would use there, its quality held (rmse vs
    the truth within 0.5 mm of the K3 fit's, mean float64 exact-NLL cost
    <= 0.7 nats); ``blocked_min_n`` the N from which the blocked objective
    beats K3 on value + gradient, else 2049. A tie (within 10%) goes to the
    exact objective."""
    m = routed_nystroem_m(config, n)
    if m:
        return f"nystroem:{m}"
    if config.backend in ("fused", "pallas"):
        return "fused"
    if config.backend != "auto":
        return config.backend
    if n % blocked_gp.BLK == 0 and n >= blocked_min_n():
        return "blocked"
    if fused_gp.supported(n):
        return "fused"
    if n % blocked_gp.BLK == 0:
        return "blocked"
    return "xla"


def _batched_fns(kind: K.Kernel, jitter: float, backend: str, x, y, mask):
    """(value_fn, vg_fn, pair) for one batch. ``value_fn`` and ``vg_fn``
    take ``(h, rows)``: ``h`` (R, 5) log-hypers for the rows ``rows`` (an
    index tensor) of the batch, or for all of them where ``rows`` is None.
    Rows are independent, so evaluating a subset gives those rows what the
    whole batch would.

    ``pair`` is ``(value_and_factors_fn, grad_from_factors_fn)`` on the
    blocked backend, else None: the line search carries each trial's
    factorization, and the gradient at the accepted point reuses it instead
    of factoring again (``optimizer.py:219-295``). K3 keeps its factor on
    chip and cannot export one."""
    def data(rows):
        if rows is None:
            return x, y, mask
        return tuple(a.index_select(0, rows) for a in (x, y, mask))

    kw = dict(kind=kind, jitter=jitter)
    if backend == "fused":
        return (lambda h, rows=None: fused_gp.gp_nll(h, *data(rows), **kw),
                lambda h, rows=None: fused_gp.gp_nll_and_grad(h, *data(rows), **kw), None)
    if backend.startswith("nystroem:"):
        mi = int(backend.split(":", 1)[1])
        return (lambda h, rows=None: nystroem_gp.gp_nll_nystroem(h, *data(rows), mi, **kw),
                lambda h, rows=None: nystroem_gp.gp_nll_and_grad_nystroem(h, *data(rows), mi,
                                                                          **kw),
                None)
    if backend == "blocked":
        pair = (
            lambda h, rows=None: blocked_gp.gp_nll_blocked_with_factors(h, *data(rows), **kw),
            lambda h, factors, rows=None: blocked_gp.gp_grad_blocked_from_factors(
                h, *data(rows), factors, **kw),
        )
        return (lambda h, rows=None: blocked_gp.gp_nll_blocked(h, *data(rows), **kw),
                lambda h, rows=None: blocked_gp.gp_nll_and_grad_blocked(h, *data(rows), **kw),
                pair)

    def value_fn(h, rows=None):
        return exact_gp.neg_log_marginal_likelihood(h, *data(rows), **kw)

    def vg_fn(h, rows=None):
        with torch.enable_grad():
            hg = h.detach().requires_grad_()
            v = exact_gp.neg_log_marginal_likelihood(hg, *data(rows), **kw)
            # rows are independent, so the gradient of the sum is per row
            (g,) = torch.autograd.grad(v.sum(), hg)
        return v.detach(), g

    return value_fn, vg_fn, None


class _Knobs(NamedTuple):
    """The convergence knobs a segment reads."""

    grad_tol: float
    ftol_abs: float
    patience: int

    @staticmethod
    def of(config: OptimizeConfig) -> "_Knobs":
        return _Knobs(config.grad_tol, config.ftol_abs, config.ftol_patience)


class LbfgsState(NamedTuple):
    """Full per-cell L-BFGS state, resumable across segments. Every field's
    batch axis is independent per cell, so rows can be gathered, compacted and
    written back between segments without changing any cell's trajectory."""

    params: torch.Tensor  # (B, P)
    value: torch.Tensor  # (B,) NLL at params
    grad: torch.Tensor  # (B, P)
    s_h: torch.Tensor  # (m, B, P) history of steps
    y_h: torch.Tensor  # (m, B, P) history of gradient differences
    rho_h: torch.Tensor  # (m, B)
    n_st: torch.Tensor  # (B,) int32 history fill count
    it_cell: torch.Tensor  # (B,) int32 iterations this cell has advanced
    gnorm: torch.Tensor  # (B,)
    stop: torch.Tensor  # (B,) bool: line-search failure / nonfinite start
    t_carry: torch.Tensor  # (B,) last accepted step length
    plateau: torch.Tensor  # (B,) int32 consecutive sub-ftol_abs improvements

    def live(self, knobs: _Knobs) -> torch.Tensor:
        return (self.gnorm > knobs.grad_tol) & ~self.stop & (self.plateau < knobs.patience)

    def converged_mask(self, knobs: _Knobs) -> torch.Tensor:
        return (self.gnorm <= knobs.grad_tol) | (self.plateau >= knobs.patience)


# Fields whose batch axis is the second one.
_HIST_FIELDS = ("s_h", "y_h", "rho_h")


def _rows(state: LbfgsState, idx: torch.Tensor) -> LbfgsState:
    """The state of rows ``idx`` (a gather on the device)."""
    return LbfgsState(*(
        f.index_select(1 if name in _HIST_FIELDS else 0, idx)
        for name, f in zip(LbfgsState._fields, state)
    ))


def _write_rows(full: LbfgsState, idx: torch.Tensor, part: LbfgsState) -> None:
    """Write ``part`` into rows ``idx`` of ``full``, in place."""
    for name, dst, src in zip(LbfgsState._fields, full, part):
        dst.index_copy_(1 if name in _HIST_FIELDS else 0, idx, src)


def lbfgs_state_from_numpy(d: dict, device=None) -> LbfgsState:
    """An :class:`LbfgsState` from the JAX package's ``LbfgsState._asdict()``
    as numpy arrays (history fields ``(m, B, P)``), so a run can be carried
    from one package to the other between two iterations."""
    return LbfgsState(**{
        name: torch.tensor(np.asarray(d[name]), device=device) for name in LbfgsState._fields
    })


def lbfgs_state_to_numpy(state: LbfgsState) -> dict:
    """The inverse of :func:`lbfgs_state_from_numpy`."""
    return {name: f.detach().cpu().numpy() for name, f in zip(LbfgsState._fields, state)}


def _lbfgs_init(vg_fn: Callable, h0: torch.Tensor) -> LbfgsState:
    m = _LBFGS_HISTORY
    b, nparam = h0.shape
    v0, g0 = vg_fn(h0)
    g0 = torch.where(torch.isfinite(g0), g0, 0.0)
    i32 = dict(dtype=torch.int32, device=h0.device)
    return LbfgsState(
        params=h0,
        value=v0,
        grad=g0,
        s_h=h0.new_zeros((m, b, nparam)),
        y_h=h0.new_zeros((m, b, nparam)),
        rho_h=h0.new_zeros((m, b)),
        n_st=torch.zeros(b, **i32),
        it_cell=torch.zeros(b, **i32),
        gnorm=torch.linalg.vector_norm(g0, dim=1),
        stop=~torch.isfinite(v0),
        t_carry=h0.new_ones(b),
        plateau=torch.zeros(b, **i32),
    )


def _rows_of(flags: torch.Tensor) -> Optional[torch.Tensor]:
    """The indices of the set flags, None where every flag is set. Their
    number comes to the host: a synchronisation, counted."""
    counters.bump(_lbfgs_segment, "host_syncs")
    rows = torch.nonzero(flags)[:, 0]
    return None if rows.numel() == flags.numel() else rows


def _take(a: torch.Tensor, rows: Optional[torch.Tensor]) -> torch.Tensor:
    return a if rows is None else a.index_select(0, rows)


def _put(a: torch.Tensor, rows: Optional[torch.Tensor], values: torch.Tensor) -> torch.Tensor:
    """``a`` with ``values`` at ``rows`` (a copy; all rows where None)."""
    return values if rows is None else a.index_copy(0, rows, values)


def _direction(grad, s_h, y_h, rho_h, n_st):
    """Two-loop recursion; history slot k is valid where k >= m - n_st."""
    m = _LBFGS_HISTORY
    q = grad
    alphas = []
    for k in range(m - 1, -1, -1):
        valid = (k >= (m - n_st))[:, None]  # (B, 1)
        a = rho_h[k][:, None] * (s_h[k] * q).sum(dim=1, keepdim=True)
        a = torch.where(valid, a, 0.0)
        q = q - a * y_h[k]
        alphas.append((k, a, valid))
    sy = (s_h[m - 1] * y_h[m - 1]).sum(dim=1, keepdim=True)
    yy = (y_h[m - 1] * y_h[m - 1]).sum(dim=1, keepdim=True)
    # the 1e-300 floor is 0 in float32, as in the JAX package: the where guards it
    gamma = torch.where((n_st > 0)[:, None] & (yy > 0.0), sy / yy.clamp_min(1e-300), 1.0)
    r = gamma * q
    for k, a, valid in reversed(alphas):
        bb = rho_h[k][:, None] * (y_h[k] * r).sum(dim=1, keepdim=True)
        bb = torch.where(valid, bb, 0.0)
        r = r + (a - bb) * s_h[k]
    return -r


def _line_search(value_fn, params, value, grad, d, live, live_rows, t_carry, pair=None):
    """Armijo backtracking of at most ``_LS_MAX_STEPS`` halvings, every cell
    from its own first trial step: the 1-nat norm cap, warm-started from
    twice the last accepted step. Returns (t, value at t, Armijo holds,
    factors).

    Only the rows still searching are evaluated (the JAX package's
    ``while_loop`` evaluates every row again at its unchanged point and
    discards the value): a cell's trajectory is the same, and a chunk no
    longer pays twelve evaluations of all its rows for one hard cell.

    With the blocked backend's ``pair``, ``factors`` holds the factorization
    of each live row's current trial point, in the order of ``live_rows``:
    each evaluation's factors are written into it at its rows' places, so
    the gradient at the final t needs no factorization of its own."""
    gd = (grad * d).sum(dim=1)
    dnorm = torch.linalg.vector_norm(d, dim=1)
    t = torch.minimum(torch.ones_like(dnorm), _MAX_STEP / dnorm.clamp_min(1e-30))
    t = torch.minimum(t, 2.0 * t_carry)

    def armijo(t, v):
        return v <= value + _LS_C1 * t * gd

    def trial(t, rows):
        p = _take(params + t[:, None] * d, rows)
        return (value_fn(p, rows), None) if pair is None else pair[0](p, rows)

    v_live, factors = trial(t, live_rows)
    v = _put(value, live_rows, v_live)
    tries = torch.zeros_like(live, dtype=torch.int32)
    while True:
        active = (tries < _LS_MAX_STEPS) & live & ~armijo(t, v)
        rows = _rows_of(active)
        if rows is not None and rows.numel() == 0:
            break
        t = torch.where(active, t * 0.5, t)
        v_rows, f_rows = trial(t, rows)
        v = _put(v, rows, v_rows)
        if pair is not None:
            if rows is None:
                factors = f_rows
            else:  # the rows' places among the live rows
                at = rows if live_rows is None else torch.searchsorted(live_rows, rows)
                for carried, new in zip(factors, f_rows):
                    carried.index_copy_(0, at, new)
        tries = tries + active.to(torch.int32)
    return t, v, armijo(t, v), factors


@torch.no_grad()
def _lbfgs_segment(value_fn, vg_fn, state: LbfgsState, knobs: _Knobs,
                   seg_iters: int, pair=None) -> LbfgsState:
    """Advance every live cell by up to ``seg_iters`` iterations
    (``optimizer.py:376-525``); the objective is evaluated for live rows
    only, and with ``pair`` (blocked backend) the gradient reuses the line
    search's factors. ``_lbfgs_segment.host_syncs`` counts the reads from
    the device."""
    m = _LBFGS_HISTORY
    st = state
    for _ in range(seg_iters):
        live = st.live(knobs)
        live_rows = _rows_of(live)
        if live_rows is not None and live_rows.numel() == 0:
            break
        params, value, grad = st.params, st.value, st.grad
        d = _direction(grad, st.s_h, st.y_h, st.rho_h, st.n_st)
        descent = ((grad * d).sum(dim=1) < 0.0)[:, None]
        d = torch.where(descent, d, -grad)

        t, new_v, ls_ok, factors = _line_search(value_fn, params, value, grad, d, live,
                                                live_rows, st.t_carry, pair)
        new_p = params + t[:, None] * d
        if pair is None:
            _, g_live = vg_fn(_take(new_p, live_rows), live_rows)
        else:
            g_live = pair[1](_take(new_p, live_rows), factors, live_rows)
        del factors
        new_g = _put(grad, live_rows, g_live)
        g_ok = torch.isfinite(new_g).all(dim=1)
        accept = ls_ok & g_ok & live

        s = new_p - params
        yv = new_g - grad
        sy = (s * yv).sum(dim=1)
        keep = accept & (sy > 1e-30)
        s_h2 = torch.cat([st.s_h[1:], s[None]], dim=0)
        y_h2 = torch.cat([st.y_h[1:], yv[None]], dim=0)
        rho2 = torch.cat([st.rho_h[1:], (1.0 / sy.clamp_min(1e-300))[None]], dim=0)
        s_h = torch.where(keep[None, :, None], s_h2, st.s_h)
        y_h = torch.where(keep[None, :, None], y_h2, st.y_h)
        rho_h = torch.where(keep[None, :], rho2, st.rho_h)
        n_st = torch.where(keep, (st.n_st + 1).clamp_max(m), st.n_st)

        # Plateau accounting: accepted steps with < ftol_abs improvement
        # count up; a real improvement resets the counter.
        small = (value - new_v) < knobs.ftol_abs
        plateau = torch.where(accept, torch.where(small, st.plateau + 1, 0), st.plateau)
        params = torch.where(accept[:, None], new_p, params)
        value = torch.where(accept, new_v, value)
        grad = torch.where(accept[:, None], new_g, grad)
        gnorm = torch.where(live, torch.linalg.vector_norm(grad, dim=1), st.gnorm)
        stop = torch.where(live, ~accept, st.stop)
        t_carry = torch.where(accept, t, st.t_carry)
        it_cell = st.it_cell + live.to(torch.int32)
        st = LbfgsState(params, value, grad, s_h, y_h, rho_h, n_st, it_cell, gnorm, stop,
                        t_carry, plateau.to(torch.int32))
    return st


_lbfgs_segment.host_syncs = 0


def _expand_restarts(log_hypers0: torch.Tensor, restarts: int) -> torch.Tensor:
    """(B, 5) -> (R * B, 5): row r * B + i is cell i from restart offset r."""
    offs = torch.tensor(_RESTART_OFFSETS[:restarts], dtype=log_hypers0.dtype,
                        device=log_hypers0.device)
    return (log_hypers0[None, :, :] + offs[:, None, :]).reshape(-1, log_hypers0.shape[1])


def _best_of_restarts(res: OptimizeResult, restarts: int) -> OptimizeResult:
    """Rows ``r * B + i`` are cell i from restart r: each cell's best NLL."""
    if restarts == 1:
        return res
    b = res.nll.shape[0] // restarts
    nll = torch.where(torch.isfinite(res.nll), res.nll, float("inf")).reshape(restarts, b)
    sel = nll.argmin(dim=0) * b + torch.arange(b, device=nll.device)
    return OptimizeResult(*(f[sel] for f in res))


def _result(st: LbfgsState, knobs: _Knobs, restarts: int) -> OptimizeResult:
    """The result of a finished state; with restarts, each cell's best NLL."""
    return _best_of_restarts(
        OptimizeResult(st.params, st.value, st.it_cell, st.converged_mask(knobs)), restarts)


# optax.adam's defaults
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def _adam(value_fn, vg_fn, h0: torch.Tensor, config: OptimizeConfig) -> OptimizeResult:
    """``config.max_iters`` Adam steps of every row (``optimizer.py:546-573``,
    ``optax.adam(optax.cosine_decay_schedule(adam_lr, max_iters))``): step t
    (from 0) moves by ``lr_t m_hat / (sqrt(v_hat) + eps)`` with
    ``lr_t = adam_lr (1 + cos(pi min(t, T) / T)) / 2``; non-finite gradient
    entries are zeroed first. No row stops early and nothing comes to the
    host: one value + gradient evaluation a step, one value at the end.
    ``converged``: the last step's gradient 2-norm <= ``grad_tol``."""
    t_max = config.max_iters
    params = h0
    m = torch.zeros_like(h0)
    v = torch.zeros_like(h0)
    gnorm = torch.full((h0.shape[0],), math.inf, dtype=h0.dtype, device=h0.device)
    for t in range(t_max):
        _, g = vg_fn(params)
        g = torch.where(torch.isfinite(g), g, 0.0)
        m = (1.0 - _ADAM_B1) * g + _ADAM_B1 * m
        v = (1.0 - _ADAM_B2) * (g * g) + _ADAM_B2 * v
        m_hat = m / (1.0 - _ADAM_B1 ** (t + 1))
        v_hat = v / (1.0 - _ADAM_B2 ** (t + 1))
        lr = config.adam_lr * 0.5 * (1.0 + math.cos(math.pi * min(t, t_max) / t_max))
        params = params + (m_hat / (v_hat.sqrt() + _ADAM_EPS)) * -lr
        gnorm = torch.linalg.vector_norm(g, dim=1)
    iters = torch.full((h0.shape[0],), t_max, dtype=torch.int32, device=h0.device)
    return OptimizeResult(params, value_fn(params), iters, gnorm <= config.grad_tol)


@torch.no_grad()
def optimize_mll_batch(
    log_hypers0: torch.Tensor,  # (B, 5)
    x: torch.Tensor,  # (B, N, 3)
    y: torch.Tensor,  # (B, N) centered
    mask: torch.Tensor,  # (B, N)
    config: OptimizeConfig = OptimizeConfig(),
) -> OptimizeResult:
    """Batched MLL optimization of a bucket of cells in one lockstep run, on
    the device of its inputs (``optimizer.py:588-645``): L-BFGS or, with
    ``config.method == "adam"``, :func:`_adam`, on the objective
    :func:`_resolve_backend` routes. With ``config.restarts > 1`` every cell
    is optimized from several deterministic initializations stacked into the
    batch, and the best NLL wins."""
    backend = _resolve_backend(config, x.shape[1])
    r = config.restarts
    h0 = _expand_restarts(log_hypers0, r)
    if r > 1:
        x, y, mask = (a.repeat((r,) + (1,) * (a.dim() - 1)) for a in (x, y, mask))
    value_fn, vg_fn, pair = _batched_fns(config.kind, config.jitter, backend, x, y, mask)
    if config.method == "adam":
        return _best_of_restarts(_adam(value_fn, vg_fn, h0, config), r)
    knobs = _Knobs.of(config)
    st = _lbfgs_segment(value_fn, vg_fn, _lbfgs_init(vg_fn, h0), knobs, config.max_iters, pair)
    return _result(st, knobs, r)


def optimize_mll(
    log_hypers0: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    config: OptimizeConfig = OptimizeConfig(),
) -> OptimizeResult:
    """Minimize the masked NLL of one padded cell: the batched optimizer at
    B = 1. ``y`` must be centered (prior mean subtracted), as the reference's
    ``SMLII`` uses ``y - mX`` (``GPR_CS2S3.py:127``)."""
    r = optimize_mll_batch(log_hypers0[None], x[None], y[None], mask[None], config)
    return OptimizeResult(*(f[0] for f in r))


@torch.no_grad()
def optimize_mll_chunked(
    log_hypers0: torch.Tensor,  # (B, 5)
    x: torch.Tensor,  # (B, N, 3)
    y: torch.Tensor,  # (B, N) centered
    mask: torch.Tensor,  # (B, N)
    config: OptimizeConfig,
    chunk_rows: int,
    segment_iters: int = 10,
    lead_schedule: Optional[tuple] = None,
) -> OptimizeResult:
    """Segmented L-BFGS with compaction of converged cells
    (``optimizer.py:750-942``).

    Runs the lockstep L-BFGS in chunks of at most ``chunk_rows`` rows,
    ``segment_iters`` iterations per sweep over the live rows. Between
    sweeps, converged and stopped rows are dropped and the survivors packed
    into fewer chunks. Per-cell trajectories equal those of
    :func:`optimize_mll_batch`; the device time approaches the sum of
    per-cell work instead of chunks x the slowest cell's.

    ``lead_schedule`` gives the lengths of the leading sweeps (default
    :func:`_seg_schedule` at this call). A leading 0 is a verify-and-drain
    sweep: the initial NLL and gradient with no iteration, so that cells
    converged at their warm start leave before any line search; the next
    sweep resumes from that state, so the survivors' evaluations are
    unchanged.

    The inputs, the whole bucket's L-BFGS state and the result stay on the
    device of ``x``; a chunk is a gather (``index_select``) of its rows. Per
    sweep the host learns one number more, how many rows are still live.
    L-BFGS only, as in the JAX package.
    """
    if config.method != "lbfgs":
        raise ValueError("optimize_mll_chunked supports method='lbfgs' only")
    backend = _resolve_backend(config, x.shape[1])
    r = config.restarts
    b = log_hypers0.shape[0]
    h0 = _expand_restarts(log_hypers0, r)
    b_tot = r * b
    knobs = _Knobs.of(config)
    schedule = _seg_schedule() if lead_schedule is None else lead_schedule
    chunk_rows = max(1, int(chunk_rows))

    def fns(rows):
        base = rows % b if r > 1 else rows  # expanded row -> source cell
        whole = rows.numel() == b_tot and r == 1
        xi, yi, mi = (a if whole else a.index_select(0, base) for a in (x, y, mask))
        return _batched_fns(config.kind, config.jitter, backend, xi, yi, mi)

    full = None
    idx = torch.arange(b_tot, device=x.device)
    iters_done = 0
    sweep = 0
    while sweep == 0 or (iters_done < config.max_iters and idx.numel() > 0):
        seg_cap = min(schedule[sweep], segment_iters) if sweep < len(schedule) else segment_iters
        seg = max(0, min(seg_cap, config.max_iters - iters_done))
        for s in range(0, idx.numel(), chunk_rows):
            rows = idx[s : s + chunk_rows]
            value_fn, vg_fn, pair = fns(rows)
            if sweep == 0:
                st = _lbfgs_init(vg_fn, h0.index_select(0, rows))
            else:
                st = _rows(full, rows)
            st = _lbfgs_segment(value_fn, vg_fn, st, knobs, seg, pair)
            if full is None:
                full = LbfgsState(*(
                    f.new_zeros(f.shape[:1] + (b_tot,) + f.shape[2:]) if name in _HIST_FIELDS
                    else f.new_zeros((b_tot,) + f.shape[1:])
                    for name, f in zip(LbfgsState._fields, st)
                ))
            _write_rows(full, rows, st)
        idx = torch.nonzero(full.live(knobs))[:, 0]  # its size comes to the host
        counters.bump(_lbfgs_segment, "host_syncs")
        iters_done += seg
        sweep += 1
    return _result(full, knobs, r)
