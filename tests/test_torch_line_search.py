"""The packed line search against the search one halving a round, float64 on the CPU.

``optimizer._line_search`` evaluates each searching row's next k trial steps
in one objective call, k set by the objective's launch width W
(``optimizer._launch_width``: the card's SM count for K3 on a card, else 1).
Here W is forced to 1, 3, 8 and 64 on the CPU's objectives: the plain path
and K3's twin at N = 128. Every width must give what W = 1 gives, which is
the search one halving a round: ``_sequential_search`` below is that loop
as the port ran it before packing, and the reference of the unit tests.
The objectives are wrapped with a wall in hyperparameter space, where they
return +inf, so that trials are not finite and a row spends all 12 halvings.
"""

import math

import numpy as np
import pytest
import torch

from optimalinterpolation_tpu_torch.models import optimizer as TO

from . import oracle

X0 = np.log(np.array([25e3, 25e3, 1.0, 1.0, 0.1]))  # the reference x0
WIDTHS = [3, 8, 64]


def _padded_cells(seeds, n, nmax):
    xs = np.zeros((len(seeds), nmax, 3))
    ys = np.zeros((len(seeds), nmax))
    masks = np.zeros((len(seeds), nmax))
    for i, seed in enumerate(seeds):
        rng = np.random.default_rng(seed)
        x = rng.uniform(-3e5, 3e5, size=(n, 3)) * np.asarray([1, 1, 1.2e-5])
        k = oracle.matern32_gram(x, np.array([1.8e5, 1.2e5, 3.0]), 0.03)
        xs[i, :n] = x
        ys[i, :n] = rng.multivariate_normal(np.zeros(n), k + 0.003 * np.eye(n))
        masks[i, :n] = 1.0
    return [torch.tensor(a) for a in (np.tile(X0[None], (len(seeds), 1)), xs, ys, masks)]


def _same(a: TO.OptimizeResult, b: TO.OptimizeResult):
    torch.testing.assert_close(a.nll, b.nll, rtol=1e-12, atol=0)
    torch.testing.assert_close(a.log_hypers, b.log_hypers, rtol=1e-9, atol=0)
    assert torch.equal(a.iters, b.iters) and torch.equal(a.converged, b.converged)


# Past a wall in log ell_t the objectives are +inf. The cells start at
# log ell_t = 0 and climb, so for the cells whose first observation is
# positive, the wall at 0 puts every trial of their first step past it: they
# spend all 12 halvings and stop. The others' wall, at 1, is crossed by long
# trials on their way.
def _wall(y):
    return torch.where(y[:, 0] > 0.0, 0.0, 1.0)


class _Walled:
    """Wraps ``optimizer._objective_fns``: value and gradient +inf / NaN past
    each row's wall; counts value calls, and the non-finite values they
    return. Forces the launch width to ``width``."""

    def __init__(self, monkeypatch, width):
        self.calls = 0
        self.nonfinite = 0
        orig = TO._objective_fns

        def fns(kind, jitter, backend, x, y, mask):
            value_fn, vg_fn, pair = orig(kind, jitter, backend, x, y, mask)

            def past(h, rows):
                return h[:, 2] > _wall(TO._take(y, rows))

            def value(h, rows=None):
                self.calls += 1
                v = torch.where(past(h, rows), math.inf, value_fn(h, rows))
                self.nonfinite += int((~torch.isfinite(v)).sum())
                return v

            def vg(h, rows=None):
                v, g = vg_fn(h, rows)
                out = past(h, rows)
                return torch.where(out, math.inf, v), torch.where(out[:, None], math.nan, g)

            return value, vg, pair

        monkeypatch.setattr(TO, "_objective_fns", fns)
        monkeypatch.setattr(TO, "_launch_width", lambda backend, device: width)


CASES = {
    # name: (backend, cells, N, padded N)
    "plain": ("xla", 11, 48, 64),
    "k3_twin": ("auto", 6, 100, 128),
}


def _runs(case, width, monkeypatch):
    """optimize_mll_batch, and optimize_mll_chunked with compaction and a
    leading 0 sweep, at launch width ``width``; the wrapper's counts and
    the line search's counters over both."""
    backend, cells, n, nmax = CASES[case]
    args = _padded_cells(range(cells), n, nmax)
    cfg = TO.OptimizeConfig(max_iters=30, backend=backend, jitter=1e-6, ftol_abs=1e-3)
    walled = _Walled(monkeypatch, width)
    ls0 = {k: getattr(TO._line_search, k) for k in ("packed_launches", "trials", "spare_trials")}
    syncs0 = TO._lbfgs_segment.host_syncs
    batch = TO.optimize_mll_batch(*args, cfg)
    chunked = TO.optimize_mll_chunked(*args, cfg, chunk_rows=4, segment_iters=5,
                                      lead_schedule=(0, 1, 4))
    counts = {k: getattr(TO._line_search, k) - v for k, v in ls0.items()}
    counts.update(calls=walled.calls, nonfinite=walled.nonfinite,
                  syncs=TO._lbfgs_segment.host_syncs - syncs0)
    return batch, chunked, counts


_SEQUENTIAL = {}


def _sequential_runs(case):
    if case not in _SEQUENTIAL:
        with pytest.MonkeyPatch.context() as mp:
            _SEQUENTIAL[case] = _runs(case, 1, mp)
    return _SEQUENTIAL[case]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_fits_match_one_halving_a_round(case, width, monkeypatch):
    """Every cell's fit at W = 3, 8, 64 is its fit at W = 1: the same
    iterations and convergence, in the batch and in chunks; with fewer
    objective calls and syncs, and as many trials as W = 1 plus the spare."""
    batch1, chunked1, one = _sequential_runs(case)
    batch, chunked, got = _runs(case, width, monkeypatch)
    _same(batch, batch1)
    _same(chunked, chunked1)
    _same(chunked, batch)
    # the wall is crossed, and a cell spends all 12 halvings and stops
    assert one["nonfinite"] > 0
    assert bool((~batch1.converged & (batch1.iters == 1)).any())
    assert one["packed_launches"] == 0 and one["spare_trials"] == 0
    assert got["packed_launches"] > 0
    assert got["calls"] < one["calls"] and got["syncs"] < one["syncs"]
    assert got["trials"] == one["trials"] + got["spare_trials"]


def _sequential_search(value_fn, params, value, grad, d, live, live_rows, t_carry):
    """The line search one halving a round, as the port ran it before
    packing (``_line_search`` without ``pair``)."""
    gd = (grad * d).sum(dim=1)
    dnorm = torch.linalg.vector_norm(d, dim=1)
    t = torch.minimum(torch.ones_like(dnorm), TO._MAX_STEP / dnorm.clamp_min(1e-30))
    t = torch.minimum(t, 2.0 * t_carry)

    def armijo(t, v):
        return v <= value + TO._LS_C1 * t * gd

    def trial(t, rows):
        return value_fn(TO._take(params + t[:, None] * d, rows), rows)

    v = TO._put(value, live_rows, trial(t, live_rows))
    tries = torch.zeros_like(live, dtype=torch.int32)
    while True:
        active = (tries < TO._LS_MAX_STEPS) & live & ~armijo(t, v)
        rows = torch.nonzero(active)[:, 0]
        if rows.numel() == 0:
            break
        rows = None if rows.numel() == active.numel() else rows
        t = torch.where(active, t * 0.5, t)
        v = TO._put(v, rows, trial(t, rows))
        tries = tries + active.to(torch.int32)
    return t, v, armijo(t, v)


def _bumpy(b, seed):
    """A batch of ``b`` rows of a bumpy objective with a wall (+inf where
    h_1 > 2.5), and its line-search inputs: rows that pass at their first
    trial, rows that pass after some halvings, rows whose long trials are
    past the wall, and row 0, whose every trial is past it."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, dtype=torch.float64)

    params = rand(b, 5) * 4.0 - 2.0
    freq = 1.0 + 6.0 * rand(b)

    def f(h, rows=None):
        fr = freq if rows is None else freq.index_select(0, rows)
        v = (h * h).sum(dim=1) + torch.sin(fr * h[:, 0]) * 2.0
        v = torch.where(h[:, 1] > 2.5, math.inf, v)
        f.nonfinite += int(torch.isinf(v).sum())
        f.evaluated += h.shape[0]
        return v

    f.nonfinite = f.evaluated = 0
    params[0, 1] = 2.5
    params[2, 1] = 2.0
    with torch.enable_grad():
        hg = params.clone().requires_grad_()
        (grad,) = torch.autograd.grad(f(hg).sum(), hg)
    d = -grad * (0.2 + 3.0 * rand(b, 1))
    d[0, 1] = 1.0  # every trial of row 0 is past the wall
    d[2, 1] = 3.0
    t_carry = 0.05 + 4.0 * rand(b)
    return f, params, f(params), grad, d, t_carry


def _exactly(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("width", [1] + WIDTHS + [132])
@pytest.mark.parametrize("subset", [False, True])
def test_packed_search_matches_the_sequential_loop(width, subset):
    """t, its value and the Armijo flag bit for bit those of the loop one
    halving a round, for searched rows and the rest alike; row 0 ends at
    its 12th halving; trials past the wall are not finite."""
    b = 40
    f, params, value, grad, d, t_carry = _bumpy(b, seed=7)
    live = torch.ones(b, dtype=torch.bool)
    live_rows = None
    if subset:
        live[3::3] = False
        live_rows = torch.nonzero(live)[:, 0]
    f.evaluated = 0
    want = _sequential_search(f, params, value, grad, d, live, live_rows, t_carry)
    sequential = f.evaluated
    f.width = width
    f.nonfinite = f.evaluated = 0
    trials0, spare0 = TO._line_search.trials, TO._line_search.spare_trials
    t, v, ok, factors = TO._line_search(f, params, value, grad, d, live_rows, t_carry)
    assert factors is None
    for got, ref in zip((t, v, ok), want):
        _exactly(got, ref)
    assert f.nonfinite > 0 and not bool(ok[0]) and bool(ok.any())
    t0 = torch.minimum(torch.ones(()), TO._MAX_STEP / torch.linalg.vector_norm(d[0]))
    t0 = torch.minimum(t0, 2.0 * t_carry[0])
    for _ in range(TO._LS_MAX_STEPS):
        t0 = t0 * 0.5
    assert torch.equal(t[0], t0)  # row 0 spent all 12 halvings
    # every point evaluated is counted, and those past a row's taken trial
    spare = TO._line_search.spare_trials - spare0
    assert TO._line_search.trials - trials0 == f.evaluated == sequential + spare
    if width == 1:
        assert spare == 0
    if width >= 64:  # the first round already carries three trials a row
        assert spare > 0


def test_pair_factors_follow_the_trial_taken():
    """With a ``pair`` (the blocked objective's carried factors) the factors
    are those of each live row's taken trial, whatever the width."""
    b = 24
    f, params, value, grad, d, t_carry = _bumpy(b, seed=11)
    live_rows = torch.arange(1, b, 2)

    def with_factors(h, rows=None):
        return f(h, rows), (h.clone(), f(h, rows)[:, None].clone())

    ref = None
    for width in (1, 5, 64):
        f.width = width
        t, v, ok, factors = TO._line_search(f, params, value, grad, d, live_rows, t_carry,
                                            pair=(with_factors, None))
        point = (params + t[:, None] * d).index_select(0, live_rows)
        assert torch.equal(factors[0], point)
        assert torch.equal(factors[1][:, 0], v.index_select(0, live_rows))
        if ref is None:
            ref = (t, v, ok)
        for got, want in zip((t, v, ok), ref):
            assert torch.equal(got, want)
