"""BFGS minimization of one small parameter vector, with a strong-Wolfe line
search: :func:`minimize_bfgs` is the port's ``jax.scipy.optimize.minimize(fun,
x0, method="BFGS", options={...})``, the options given as its keywords.

A translation of JAX's ``minimize_bfgs`` (Nocedal and Wright, Algorithm
6.1: inf-norm ``gtol`` 1e-5, ``line_search_maxiter`` 10, the first
``old_old_fval = f0 + |g0|/2``, the inverse-Hessian update kept where
``1 / y.s`` is finite) and of its zoom line search (Algorithms 3.5 and 3.6:
``c1`` 1e-4, ``c2`` 0.9; cubic, quadratic or bisection trial steps), with its
quirks kept: a failed line search still moves x by its step, a zoom that
never met the Wolfe conditions returns its initial step 1 and the value at
its low end, and below float64 a step shorter than 1e-8 is raised to 1e-8.
The gradient comes from ``torch.autograd``. It is a plain loop: each test of
a condition reads a scalar from the device of ``x0`` (one host
synchronisation), which one cell can afford; it is the ``cell`` command's
optimizer (``cli.py``), not the batched one of the day.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["OptimizeResults", "minimize_bfgs", "line_search"]


class OptimizeResults(NamedTuple):
    """``jax.scipy.optimize.OptimizeResults``: status 0 converged, 1 the
    iteration limit, 3 a zoom failed, 5 the line search's iteration limit."""

    x: torch.Tensor
    success: bool
    status: int
    fun: torch.Tensor
    jac: torch.Tensor
    hess_inv: torch.Tensor
    nfev: int
    njev: int
    nit: int


def _value_and_grad(fun: Callable, x: torch.Tensor):
    with torch.enable_grad():
        xg = x.detach().requires_grad_()
        f = fun(xg)
        (g,) = torch.autograd.grad(f, xg)
    return f.detach(), g


def _below_float64(t: torch.Tensor) -> bool:
    return torch.finfo(t.dtype).bits < 64


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through (a, fa) with slope fpa, (b, fb), (c, fc)."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    d2 = (fb - fa - fpa * db, fc - fa - fpa * dc)
    aa = (dc ** 2 * d2[0] + (-db ** 2) * d2[1]) / denom
    bb = ((-dc ** 3) * d2[0] + db ** 3 * d2[1]) / denom
    return a + (-bb + torch.sqrt(bb * bb - 3.0 * aa * fpa)) / (3.0 * aa)


def _quadmin(a, fa, fpa, b, fb):
    """Minimizer of the quadratic through (a, fa) with slope fpa and (b, fb)."""
    db = b - a
    return a - fpa / (2.0 * ((fb - fa - fpa * db) / (db ** 2)))


class _Point(NamedTuple):
    a: torch.Tensor
    phi: torch.Tensor
    dphi: torch.Tensor


def _zoom(evaluate, wolfe_one, wolfe_two, lo: _Point, hi: _Point, g_0):
    """Algorithm 3.6 between ``lo`` and ``hi`` (``line_search.py::_zoom``).
    Returns (star point, its gradient, failed, evaluations)."""
    rec = _Point((lo.a + hi.a) / 2.0, (lo.phi + hi.phi) / 2.0, None)
    star, g_star = _Point(torch.ones_like(lo.a), lo.phi, lo.dphi), g_0
    done = failed = False
    j = nfev = 0
    threshold = 1e-5 if _below_float64(lo.a) else 1e-10
    while not done and not failed:
        dalpha = hi.a - lo.a
        lo_end, hi_end = torch.minimum(hi.a, lo.a), torch.maximum(hi.a, lo.a)
        failed = failed or bool(dalpha <= threshold)
        a_cubic = _cubicmin(lo.a, lo.phi, lo.dphi, hi.a, hi.phi, rec.a, rec.phi)
        use_cubic = j > 0 and bool((a_cubic > lo_end + 0.2 * dalpha)
                                   & (a_cubic < hi_end - 0.2 * dalpha))
        a_quad = _quadmin(lo.a, lo.phi, lo.dphi, hi.a, hi.phi)
        use_quad = not use_cubic and bool((a_quad > lo_end + 0.1 * dalpha)
                                          & (a_quad < hi_end - 0.1 * dalpha))
        a_j = a_cubic if use_cubic else a_quad if use_quad else (lo.a + hi.a) / 2.0
        phi_j, dphi_j, g_j = evaluate(a_j)
        nfev += 1
        hi_to_j = bool(wolfe_one(a_j, phi_j) | (phi_j >= lo.phi))
        star_to_j = not hi_to_j and bool(wolfe_two(dphi_j))
        hi_to_lo = not hi_to_j and not star_to_j and bool(dphi_j * (hi.a - lo.a) >= 0.0)
        lo_to_j = not hi_to_j and not star_to_j
        j_point = _Point(a_j, phi_j, dphi_j)
        if hi_to_j:
            rec, hi = _Point(hi.a, hi.phi, None), j_point
        if star_to_j:
            done, star, g_star = True, j_point, g_j
        if hi_to_lo:
            rec, hi = _Point(hi.a, hi.phi, None), lo
        elif lo_to_j:
            rec = _Point(lo.a, lo.phi, None)
        if lo_to_j:
            lo = j_point
        j += 1
        failed = failed or j >= 30
    return star, g_star, failed, nfev


class _LineSearchResults(NamedTuple):
    failed: bool
    nit: int
    nfev: int
    ngev: int
    k: int
    a_k: torch.Tensor
    f_k: torch.Tensor
    g_k: torch.Tensor
    status: int


def line_search(fun: Callable, xk: torch.Tensor, pk: torch.Tensor, old_fval: torch.Tensor,
                old_old_fval: torch.Tensor, gfk: torch.Tensor, c1: float = 1e-4,
                c2: float = 0.9, maxiter: int = 20) -> _LineSearchResults:
    """Inexact line search for the strong Wolfe conditions along ``pk``
    from ``xk``, where the value ``old_fval`` and gradient ``gfk`` are
    known (``line_search.py::line_search``)."""
    def evaluate(t):
        phi, g = _value_and_grad(fun, xk + t * pk)
        return phi, (g * pk).sum(), g

    phi_0, dphi_0 = old_fval, (gfk * pk).sum()
    candidate = 1.01 * 2 * (phi_0 - old_old_fval) / dphi_0
    start = torch.where(candidate > 1, torch.ones_like(candidate), candidate)

    def wolfe_one(a, phi):  # the negation of the sufficient decrease
        return phi > phi_0 + c1 * a * dphi_0

    def wolfe_two(dphi):
        return dphi.abs() <= -c2 * dphi_0

    prev = _Point(torch.zeros_like(phi_0), phi_0, dphi_0)
    star, g_star = prev, gfk
    done = failed = False
    i, nfev = 1, 0
    while not done and i <= maxiter and not failed:
        a_i = start if i == 1 else prev.a * 2.0
        phi_i, dphi_i, g_i = evaluate(a_i)
        nfev += 1
        cur = _Point(a_i, phi_i, dphi_i)
        to_zoom1 = bool(wolfe_one(a_i, phi_i) | ((phi_i >= prev.phi) & (i > 1)))
        to_i = not to_zoom1 and bool(wolfe_two(dphi_i))
        to_zoom2 = not to_zoom1 and not to_i and bool(dphi_i >= 0.0)
        if to_zoom1:
            star, g_star, zoom_failed, n = _zoom(evaluate, wolfe_one, wolfe_two, prev, cur, gfk)
            done, failed, nfev = True, zoom_failed, nfev + n
        elif to_i:
            done, star, g_star = True, cur, g_i
        elif to_zoom2:
            star, g_star, zoom_failed, n = _zoom(evaluate, wolfe_one, wolfe_two, cur, prev, gfk)
            done, failed, nfev = True, zoom_failed, nfev + n
        i += 1
        prev = cur
    status = 1 if failed else 3 if i > maxiter else 0
    a_k = star.a
    if _below_float64(a_k) and bool(a_k.abs() < 1e-8):  # a floor below float64
        a_k = torch.sign(a_k) * 1e-8
    return _LineSearchResults(failed=failed or not done, nit=i - 1, nfev=nfev, ngev=nfev, k=i,
                              a_k=a_k, f_k=star.phi, g_k=g_star, status=status)


def minimize_bfgs(fun: Callable, x0: torch.Tensor, maxiter: Optional[int] = None,
                  norm: float = math.inf, gtol: float = 1e-5,
                  line_search_maxiter: int = 10) -> OptimizeResults:
    """BFGS from ``x0`` (``bfgs.py::minimize_bfgs``): stops when
    ``|g|_norm < gtol``, when a line search fails, or after ``maxiter``
    iterations (default 200 per parameter)."""
    if maxiter is None:
        maxiter = x0.numel() * 200
    eye = torch.eye(x0.shape[0], dtype=x0.dtype, device=x0.device)
    x, h = x0, eye
    f, g = _value_and_grad(fun, x0)
    old_old_fval = f + torch.linalg.vector_norm(g) / 2
    converged = bool(torch.linalg.vector_norm(g, ord=norm) < gtol)
    failed = False
    k, nfev, ls_status = 0, 1, 0
    while not converged and not failed and k < maxiter:
        p = -(h @ g)
        ls = line_search(fun, x, p, old_fval=f, old_old_fval=old_old_fval, gfk=g,
                         maxiter=line_search_maxiter)
        nfev += ls.nfev
        failed, ls_status = ls.failed, ls.status
        s = ls.a_k * p
        y = ls.g_k - g
        rho = 1.0 / (y * s).sum()
        w = eye - rho * (s[:, None] * y[None, :])
        h_new = w @ h @ w.mT + rho * (s[:, None] * s[None, :])
        h = torch.where(torch.isfinite(rho), h_new, h)
        converged = bool(torch.linalg.vector_norm(ls.g_k, ord=norm) < gtol)
        k += 1
        x, old_old_fval, f, g = x + s, f, ls.f_k, ls.g_k
    status = 0 if converged else 1 if k == maxiter else 2 + ls_status if failed else -1
    return OptimizeResults(x=x, success=converged and not failed, status=status, fun=f, jac=g,
                           hess_inv=h, nfev=nfev, njev=nfev, nit=k)

