"""The port's batched L-BFGS against the JAX package, float64 on the CPU.

The same cells (seeded numpy draws from the Matern-3/2 GP the model fits,
as tests/test_optimizer.py makes them) go through
``optimize_mll_batch`` of both packages with the plain objective
(``backend="xla"``). The two run the same algorithm in the same order, so the
per-cell iteration counts are equal; the hyperparameters agree to 1e-6 and
the NLL to 1e-9 relative (reached: ~1e-9 and ~1e-13; the objective's
reductions run in another order, and an optimizer amplifies that along its
trajectory). Everything else is the port against itself: chunking,
segmentation, compaction and restarts must be invisible to a cell.

One JAX executable is compiled (the (4, 64) sweep), used by two tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalinterpolation_tpu.models import optimizer as JO
from optimalinterpolation_tpu_torch.models import optimizer as TO

from . import oracle

X0 = np.log(np.array([25e3, 25e3, 1.0, 1.0, 0.1]))  # the reference x0


def _padded_cells(seeds, n=48, nmax=64):
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
    return xs, ys, masks


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _h0(b):
    return np.tile(X0[None], (b, 1))


def _same(a: TO.OptimizeResult, b: TO.OptimizeResult):
    torch.testing.assert_close(a.nll, b.nll, rtol=1e-12, atol=0)
    torch.testing.assert_close(a.log_hypers, b.log_hypers, rtol=1e-9, atol=0)
    assert torch.equal(a.iters, b.iters) and torch.equal(a.converged, b.converged)


def test_batch_matches_jax():
    xs, ys, masks = _padded_cells(range(4))
    kw = dict(max_iters=25, ftol_abs=1e-3, jitter=1e-6, backend="xla")
    ref = JO.optimize_mll_batch(*map(jnp.asarray, (_h0(4), xs, ys, masks)), JO.OptimizeConfig(**kw))
    got = TO.optimize_mll_batch(*_t(_h0(4), xs, ys, masks), TO.OptimizeConfig(**kw))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(got.log_hypers.numpy(), np.asarray(ref.log_hypers), atol=1e-6)
    np.testing.assert_allclose(got.nll.numpy(), np.asarray(ref.nll), rtol=1e-9)
    assert got.iters.min() > 3  # the cells really iterate


def test_state_carries_over_from_jax_mid_run():
    """k iterations in JAX, the state handed over as numpy, the rest here:
    the same end as the port's own whole run."""
    xs, ys, masks = _padded_cells(range(4))
    kw = dict(max_iters=25, ftol_abs=1e-3, jitter=1e-6, backend="xla")
    jcfg, tcfg = JO.OptimizeConfig(**kw), TO.OptimizeConfig(**kw)
    k = 6
    mid = JO._lbfgs_sweep_impl(
        JO._blank_state(jnp.asarray(_h0(4))), *map(jnp.asarray, (xs, ys, masks)),
        jnp.asarray(True), JO._Knobs.of(jcfg, jnp.float64), jnp.asarray(k, jnp.int32),
        jcfg.kind, jcfg.jitter, "xla",
    )
    carried = {name: np.asarray(v) for name, v in jax.device_get(mid._asdict()).items()}
    state = TO.lbfgs_state_from_numpy(carried)
    assert int(state.it_cell.max()) == k and state.s_h.shape == (8, 4, 5)
    back = TO.lbfgs_state_to_numpy(state)
    for name, v in carried.items():
        np.testing.assert_array_equal(back[name], v, err_msg=name)

    x, y, m = _t(xs, ys, masks)
    value_fn, vg_fn, _ = TO._batched_fns(tcfg.kind, tcfg.jitter, "xla", x, y, m)
    knobs = TO._Knobs.of(tcfg)
    end = TO._lbfgs_segment(value_fn, vg_fn, state, knobs, tcfg.max_iters - k)
    whole = TO.optimize_mll_batch(*_t(_h0(4), xs, ys, masks), tcfg)
    assert torch.equal(end.it_cell, whole.iters)
    torch.testing.assert_close(end.params, whole.log_hypers, atol=1e-6, rtol=0)
    torch.testing.assert_close(end.value, whole.nll, rtol=1e-9, atol=0)
    assert torch.equal(end.converged_mask(knobs), whole.converged)


@pytest.mark.parametrize("restarts", [1, 2])
def test_chunked_compaction_matches_monolithic(restarts):
    """Tiny chunks with a ragged tail, short segments and compaction between
    them change no cell's result."""
    xs, ys, masks = _padded_cells(range(11))
    cfg = TO.OptimizeConfig(max_iters=30, restarts=restarts, backend="xla")
    args = _t(_h0(11), xs, ys, masks)
    mono = TO.optimize_mll_batch(*args, cfg)
    chunked = TO.optimize_mll_chunked(*args, cfg, chunk_rows=4, segment_iters=7)
    _same(chunked, mono)
    assert mono.iters.max() > 7  # several sweeps were needed


def test_zero_lead_verify_sweep_matches_monolithic():
    """A leading 0 (initial NLL and gradient, no iteration) changes nothing,
    and cells converged at their start leave in that sweep."""
    xs, ys, masks = _padded_cells(range(5))
    cfg = TO.OptimizeConfig(max_iters=30, backend="xla")
    args = _t(_h0(5), xs, ys, masks)
    mono = TO.optimize_mll_batch(*args, cfg)
    lead0 = TO.optimize_mll_chunked(*args, cfg, chunk_rows=3, segment_iters=6,
                                    lead_schedule=(0, 1, 4))
    _same(lead0, mono)
    # from the optimum, loosely: nothing is live after the verify sweep
    loose = TO.OptimizeConfig(max_iters=30, backend="xla", grad_tol=1e3)
    before = TO.fused_gp.gp_nll.launches
    again = TO.optimize_mll_chunked(mono.log_hypers, *args[1:], loose, chunk_rows=3,
                                    lead_schedule=(0, 1, 4))
    assert int(again.iters.sum()) == 0 and bool(again.converged.all())
    torch.testing.assert_close(again.log_hypers, mono.log_hypers, rtol=0, atol=0)
    assert TO.fused_gp.gp_nll.launches == before  # the twin counts no launch


def test_auto_backend_runs_the_fused_twin_on_cpu():
    """N = 128 resolves to K3, whose analytic twin runs here; same optimum
    as the autograd objective. Above K3's range "auto" takes the blocked
    objective, or Nystrom from the threshold on, never the plain path."""
    xs, ys, masks = _padded_cells(range(2), n=100, nmax=128)
    args = _t(_h0(2), xs, ys, masks)
    assert TO._resolve_backend(TO.OptimizeConfig(), 128) == "fused"
    assert TO._resolve_backend(TO.OptimizeConfig(backend="pallas"), 64) == "fused"
    assert TO._resolve_backend(TO.OptimizeConfig(), 64) == "xla"
    assert TO._resolve_backend(TO.OptimizeConfig(nystroem_min_n=0), 2048) == "blocked"
    assert TO._resolve_backend(TO.OptimizeConfig(nystroem_min_n=2048), 2048) == "nystroem:512"
    fused = TO.optimize_mll_batch(*args, TO.OptimizeConfig(max_iters=12, jitter=1e-6))
    plain = TO.optimize_mll_batch(*args, TO.OptimizeConfig(max_iters=12, jitter=1e-6,
                                                           backend="xla"))
    assert torch.equal(fused.iters, plain.iters)
    torch.testing.assert_close(fused.nll, plain.nll, rtol=1e-9, atol=0)
    torch.testing.assert_close(fused.log_hypers, plain.log_hypers, atol=1e-6, rtol=0)


def test_plateau_stop_and_patience():
    xs, ys, masks = _padded_cells(range(3))
    args = _t(_h0(3), xs, ys, masks)
    full = TO.optimize_mll_batch(*args, TO.OptimizeConfig(max_iters=60, backend="xla"))
    plat = TO.optimize_mll_batch(
        *args, TO.OptimizeConfig(max_iters=60, backend="xla", ftol_abs=1e-3, ftol_patience=3))
    assert bool(plat.converged.all()) and bool((plat.iters <= full.iters).all())
    assert float((plat.nll - full.nll).max()) < 1e-2  # stopped on the plateau, not before
    fast = TO.optimize_mll_batch(
        *args, TO.OptimizeConfig(max_iters=60, backend="xla", ftol_abs=1e9, ftol_patience=1))
    assert fast.iters.tolist() == [1, 1, 1] and bool(fast.converged.all())


def test_single_cell_and_restarts_never_worse():
    xs, ys, masks = _padded_cells(range(3))
    args = _t(_h0(3), xs, ys, masks)
    one = TO.optimize_mll_batch(*args, TO.OptimizeConfig(max_iters=20, backend="xla"))
    three = TO.optimize_mll_batch(*args, TO.OptimizeConfig(max_iters=20, backend="xla",
                                                           restarts=3))
    assert bool((three.nll <= one.nll + 1e-9).all())
    single = TO.optimize_mll(*(a[1] for a in args), TO.OptimizeConfig(max_iters=20,
                                                                     backend="xla"))
    assert single.log_hypers.shape == (5,) and single.nll.shape == ()
    torch.testing.assert_close(single.nll, one.nll[1], rtol=1e-9, atol=0)


def test_nonfinite_start_stops_at_once():
    xs, ys, masks = _padded_cells(range(2))
    h0 = _h0(2)
    h0[1] = np.nan
    res = TO.optimize_mll_batch(*_t(h0, xs, ys, masks), TO.OptimizeConfig(max_iters=5,
                                                                          backend="xla"))
    # its gradient is zeroed, so it never moves (and counts as converged, as in JAX)
    assert int(res.iters[1]) == 0 and torch.isinf(res.nll[1])
    assert bool(torch.isnan(res.log_hypers[1]).all())
    assert int(res.iters[0]) > 0 and torch.isfinite(res.nll[0])


def test_config_rejects_unknown_options():
    with pytest.raises(ValueError):
        TO.OptimizeConfig(backend="cusolver")
    with pytest.raises(ValueError, match="unknown method"):
        TO.OptimizeConfig(method="sgd")
    with pytest.raises(ValueError, match="multiple of 128"):
        TO.OptimizeConfig(nystroem_m=200)


def _blocked_cells():
    """tests/test_optimizer.py::test_blocked_backend_trajectory_matches_xla's
    cells: N = 256 (two 128 blocks), 10% padding."""
    rng = np.random.default_rng(3)
    b, n = 3, 256
    xs = rng.uniform(-3e5, 3e5, size=(b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    ys = rng.normal(0.0, 0.1, size=(b, n))
    masks = (rng.random((b, n)) < 0.9).astype(np.float64)
    return _h0(b), xs, ys, masks


@pytest.mark.parametrize("against", ["xla", "jax_blocked"])
def test_blocked_trajectory_matches(against):
    """The blocked objective with factor reuse (the line search carries each
    trial's factors, the gradient reuses the accepted one's) walks the plain
    objective's trajectory, and the JAX package's blocked one: NLL rtol
    1e-9, hypers atol 1e-5, iterations within one."""
    cells = _blocked_cells()
    kw = dict(max_iters=25, grad_tol=1e-6, jitter=1e-6)
    got = TO.optimize_mll_batch(*_t(*cells), TO.OptimizeConfig(backend="blocked", **kw))
    if against == "xla":
        ref = TO.optimize_mll_batch(*_t(*cells), TO.OptimizeConfig(backend="xla", **kw))
        ref = [f.numpy() for f in ref]
    else:
        ref = JO.optimize_mll_batch(*map(jnp.asarray, cells),
                                    JO.OptimizeConfig(backend="blocked", **kw))
        ref = [np.asarray(f) for f in ref]
    np.testing.assert_allclose(got.nll.numpy(), ref[1], rtol=1e-9)
    np.testing.assert_allclose(got.log_hypers.numpy(), ref[0], atol=1e-5)
    assert np.all(np.abs(got.iters.numpy() - ref[2]) <= 1)
    assert got.iters.min() > 3


def test_blocked_factor_reuse_survives_compaction(monkeypatch):
    """Chunks, segments and compaction with the carried factors: the same
    result as the monolithic blocked run; and every factorization is a line
    search trial's or an initial evaluation's: the gradient after a line
    search factors nothing."""
    xs, ys, masks = _padded_cells(range(5), n=200, nmax=256)
    h0 = _h0(5)
    cfg = TO.OptimizeConfig(max_iters=30, backend="blocked", jitter=1e-6)
    args = _t(h0, xs, ys, masks)
    calls = {"_prep": 0, "gp_nll_blocked_with_factors": 0, "gp_nll_and_grad_blocked": 0,
             "gp_grad_blocked_from_factors": 0}
    for name in calls:
        def counted(*a, _fn=getattr(TO.blocked_gp, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(TO.blocked_gp, name, counted)
    mono = TO.optimize_mll_batch(*args, cfg)
    # the composed value + gradient calls _with_factors and _from_factors itself
    init = calls["gp_nll_and_grad_blocked"]
    assert init == 1 and calls["_prep"] == calls["gp_nll_blocked_with_factors"]
    assert calls["gp_grad_blocked_from_factors"] - init == int(mono.iters.max())
    chunked = TO.optimize_mll_chunked(*args, cfg, chunk_rows=2, segment_iters=4,
                                      lead_schedule=(0, 1))
    torch.testing.assert_close(chunked.nll, mono.nll, rtol=1e-12, atol=0)
    torch.testing.assert_close(chunked.log_hypers, mono.log_hypers, rtol=0, atol=1e-9)
    assert torch.equal(chunked.iters, mono.iters) and mono.iters.max() > 4


def test_factor_reuse_splits_the_composed_evaluation():
    """The pair's gradient from carried factors equals the composed value +
    gradient at the same point, for a row subset."""
    xs, ys, masks = _padded_cells(range(4), n=200, nmax=256)
    h0 = _h0(4)
    x, y, m = _t(xs, ys, masks)
    h = torch.tensor(h0) + 0.1
    _, vg_fn, (vf_fn, gf_fn) = TO._batched_fns(TO.K.Kernel.MATERN32, 1e-6, "blocked", x, y, m)
    rows = torch.tensor([1, 3])
    v, factors = vf_fn(h[rows], rows)
    g = gf_fn(h[rows], factors, rows)
    v_ref, g_ref = vg_fn(h[rows], rows)
    assert torch.equal(v, v_ref)
    torch.testing.assert_close(g, g_ref, rtol=0, atol=0)


def test_nystroem_trajectory_matches_jax():
    """The rank-128 Nystrom objective at N = 256 through both packages'
    L-BFGS: the same iterations, NLL rtol 1e-9, hypers atol 1e-5."""
    xs, ys, masks = _padded_cells(range(3), n=230, nmax=256)
    kw = dict(max_iters=20, jitter=1e-6, backend="nystroem", nystroem_m=128)
    got = TO.optimize_mll_batch(*_t(_h0(3), xs, ys, masks), TO.OptimizeConfig(**kw))
    ref = JO.optimize_mll_batch(*map(jnp.asarray, (_h0(3), xs, ys, masks)),
                                JO.OptimizeConfig(**kw))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(got.nll.numpy(), np.asarray(ref.nll), rtol=1e-9)
    np.testing.assert_allclose(got.log_hypers.numpy(), np.asarray(ref.log_hypers), atol=1e-5)
    assert got.iters.min() > 3


_GRID_N = (256, 384, 512, 1024, 2048, 4096, 1000)


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas", "blocked", "nystroem"])
def test_routing_matches_jax(backend, monkeypatch):
    """routed_nystroem_m and _resolve_backend give the JAX package's answers
    for the same config over a grid of N, nystroem_min_n, nystroem_m,
    OI_NYSTROEM_MIN_N and OI_BLOCKED_MIN_N (JAX's ``"auto"`` branch as it
    runs on the TPU in float32; its ``"pallas"`` is the port's ``"fused"``)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    checked = 0
    for env_nys in (None, "0", "2048"):
        for env_blk in ("512", "2049"):
            if env_nys is None:
                monkeypatch.delenv("OI_NYSTROEM_MIN_N", raising=False)
            else:
                monkeypatch.setenv("OI_NYSTROEM_MIN_N", env_nys)
            monkeypatch.setenv("OI_BLOCKED_MIN_N", env_blk)
            assert TO.blocked_min_n() == JO.blocked_min_n()
            for min_n in (0, 512, 1024, 2048):
                for mi in (128, 512, 1024):
                    kw = dict(backend=backend, nystroem_min_n=min_n, nystroem_m=mi)
                    jcfg, tcfg = JO.OptimizeConfig(**kw), TO.OptimizeConfig(**kw)
                    for n in _GRID_N:
                        assert TO.routed_nystroem_m(tcfg, n) == JO.routed_nystroem_m(jcfg, n)
                        want = JO._resolve_backend(jcfg, n, jnp.float32)
                        want = "fused" if want == "pallas" else want
                        assert TO._resolve_backend(tcfg, n) == want, (kw, n, env_nys, env_blk)
                        checked += 1
    assert checked == 3 * 2 * 4 * 3 * len(_GRID_N)


def test_default_routing_keeps_k3_range_and_jax_config_routes_as_jax():
    """The port's defaults (measured on the card) keep every N <= 1024 on
    K3 and fit N = 2048 and 4096 on the rank-512 Nystrom objective; a config
    with the JAX package's defaults routes N = 1024 to it too, as the JAX
    package does."""
    cfg = TO.OptimizeConfig()
    assert [TO._resolve_backend(cfg, n) for n in (512, 1024, 2048, 4096, 1000)] == [
        "fused", "fused", "nystroem:512", "nystroem:512", "xla"]
    assert TO._resolve_backend(TO.OptimizeConfig(nystroem_min_n=0), 4096) == "blocked"
    jax_defaults = JO.OptimizeConfig()
    kw = dict(nystroem_min_n=jax_defaults.nystroem_min_n, nystroem_m=jax_defaults.nystroem_m)
    assert TO._resolve_backend(TO.OptimizeConfig(**kw), 1024) == "nystroem:512"
    assert TO._resolve_backend(TO.OptimizeConfig(**kw), 512) == "fused"
