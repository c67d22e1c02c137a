"""The port's daily pipeline against the JAX package, float64 on the CPU.

``interpolate_daily`` of both packages runs on the same hand-sized dataset
(tests/reference_flow.make_tiny_dataset). The quicklook path takes the same
hyperparameter fields, some of them NaN; all 15 reference-dict fields agree
to 1e-9 with identical NaN masks. Also: the chunking, the gather's shuffle,
the hypers' loader, and that the port never imports JAX. The two-pass day
is in ``test_torch_daily_two_pass.py``, the ``daily`` command in
``test_torch_daily_cli.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from optimalinterpolation_tpu.pipeline import daily as JD
from optimalinterpolation_tpu_torch.models import optimizer as TO
from optimalinterpolation_tpu_torch.pipeline import daily as TD

from .reference_flow import make_tiny_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hypers(ds):
    """Smoothly varying fields with two NaN cells inside the active disk."""
    g = ds.x.shape[0]
    wave = 1.0 + 0.2 * np.sin(np.arange(g)[:, None] / 3.0) * np.cos(np.arange(g)[None, :] / 4.0)
    res_m = ds.grid_res_km * 1e3
    h = {"ell_x": 2.5 * res_m * wave, "ell_y": 2.5 * res_m / wave, "ell_t": 2.0 * wave,
         "sf2": 0.004 * wave, "sn2": np.full((g, g), 4e-4)}
    c = g // 2
    h["sf2"][c, c] = np.nan
    h["ell_t"][c + 1, c - 2] = np.nan
    return h


def _prior_field(ds):
    """A (G, G) prior with NaN cells, which fall back to its finite mean."""
    field = 0.2 + 0.01 * np.cos(ds.x / 3e5) * np.sin(ds.y / 4e5)
    field[::5, ::3] = np.nan
    return field


@pytest.mark.parametrize("prior", ["scalar", "field"])
@pytest.mark.parametrize("buckets", [(512, 1024, 2048, 4096), (128, 256)])
def test_quicklook_day_matches_jax(buckets, prior):
    ds = make_tiny_dataset()
    hyp = _hypers(ds)
    mean = 0.2 if prior == "scalar" else _prior_field(ds)
    ref = JD.interpolate_daily(
        ds, 0, mean, JD.DailyConfig(dtype="float64", jitter=1e-6, buckets=buckets),
        precomputed_hypers=hyp,
    ).to_reference_dict()
    got = TD.interpolate_daily(
        ds, 0, mean, TD.DailyConfig(dtype="float64", jitter=1e-6, buckets=buckets),
        precomputed_hypers=hyp, device="cpu",
    ).to_reference_dict()
    assert list(got) == list(ref) and len(got) == 15
    active = np.isfinite(ds.sie[:, :, 4])
    for key, r in ref.items():
        g = got[key]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=key)
        if key.endswith("_lZ"):
            np.testing.assert_allclose(g, r, rtol=1e-9, atol=0, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, atol=1e-9, rtol=0, err_msg=key)
    interp = got[f"{ds.dates[4]}_interp_smth"]
    assert np.isfinite(interp[active]).sum() == active.sum() - 2  # the two NaN-hyper cells


def test_chunking_is_invisible(caplog):
    """Tiny chunks (many padded tiles) give the same fields as one chunk."""
    ds = make_tiny_dataset()
    hyp = _hypers(ds)
    one = TD.interpolate_daily(ds, 0, 0.2, TD.DailyConfig(dtype="float64", buckets=(256,)),
                               precomputed_hypers=hyp, device="cpu")
    with caplog.at_level("INFO", logger=TD.__name__):
        many = TD.interpolate_daily(
            ds, 0, 0.2, TD.DailyConfig(dtype="float64", buckets=(256,), max_chunk_bytes=4e6),
            precomputed_hypers=hyp, device="cpu",
        )
    (n, cells, tile, _), = [r.args for r in caplog.records if not isinstance(r.args, dict)]
    assert n == 256 and cells == np.isfinite(ds.sie[:, :, 4]).sum()
    assert tile < cells  # several chunks, the last one padded
    np.testing.assert_allclose(many.interp, one.interp, atol=1e-12, rtol=0)
    np.testing.assert_allclose(many.lZ, one.lZ, rtol=1e-12, atol=0)


def test_chunk_rows_tiles_evenly():
    cfg = TD.DailyConfig(max_chunk_bytes=16e9)
    # K2 scratch, (N^2 + 128 N) * 4 bytes a row: 3,384 rows fit at N = 1024,
    # so 8,000 rows go in 3 tiles of 2,672
    assert TD._chunk_rows(1024, 8000, cfg, 4) == 2672
    assert TD._chunk_rows(512, 56, cfg, 4) == 56
    # blocked, 2.5 (N, N) buffers a row: 88 rows fit at N = 4096
    assert TD._chunk_rows(4096, 1600, cfg, 4) == 88
    assert TD._chunk_rows(4096, 8, TD.DailyConfig(max_chunk_bytes=1.0), 4) == 8


def test_chunk_rows_optimize_model():
    cfg = TD.DailyConfig(max_chunk_bytes=16e9)
    # K3 with the gradient, (2 N^2 + 128 N) * 4 bytes a row: 1,797 rows fit at
    # N = 1024, so 8,936 rows go in 5 tiles of 1,792
    assert TD._chunk_rows(1024, 8936, cfg, 4, "fused") == 1792
    assert TD._chunk_rows(512, 1256, cfg, 4, "fused") == 1256
    # the plain autograd objective's buffers
    assert TD._chunk_rows(64, 56, cfg, 8, "xla") == 56
    # the blocked objective, _BLOCKED_OBJECTIVE_BUFFERS (N, N) a row
    rows = int(16e9 // (TD._BLOCKED_OBJECTIVE_BUFFERS * 2048 ** 2 * 4)) // 8 * 8
    assert TD._chunk_rows(2048, 4000, cfg, 4, "blocked") == -(-4000 // -(-4000 // rows) // 8) * 8
    assert TD._chunk_rows(2048, 8, cfg, 4, "blocked") == 8
    # the Nystrom objective: (N, M) and (M, M) buffers, no (N, N) one
    per_row = (TD._NYSTROEM_NM_BUFFERS * 4096 * 512 + TD._NYSTROEM_MM_BUFFERS * 512 ** 2) * 4
    assert TD._chunk_rows(4096, 100000, cfg, 4, "nystroem:512") <= 16e9 // per_row
    assert TD._chunk_rows(4096, 100000, cfg, 4, "nystroem:512") > 16e9 // per_row - 8


def test_requires_hypers_until_pass1_is_ported():
    """Pass 1 is ported, and so is every objective: ``backend="blocked"``
    runs the day through the blocked objective (K1's twin here), which the
    opt stage reports."""
    cfg = TD.DailyConfig(dtype="float64", buckets=(128,), spatial_seed_stride=0,
                         opt=TO.OptimizeConfig(backend="blocked", max_iters=3))
    stats = []
    res = TD.interpolate_daily(make_tiny_dataset(), 0, 0.2, cfg, stats=stats, device="cpu")
    opt = [e for e in stats if e["stage"] == "opt"]
    assert [e["backend"] for e in opt] == ["blocked"] and "m" not in opt[0]
    assert np.isfinite(res.interp_smth[np.isfinite(res.interp_smth)]).any()


def test_permute_valid_points_reproduces_the_jax_order():
    ds = make_tiny_dataset()
    from optimalinterpolation_tpu_torch.data.neighbors import gather_neighborhoods
    from optimalinterpolation_tpu_torch.data.window import flatten_window

    train = flatten_window(ds.obs[:, :, :, 0:9], ds.x, ds.y)
    ij = np.nonzero(np.isfinite(ds.sie[:, :, 4]))
    cells = np.stack([ds.x[ij], ds.y[ij]], axis=1)
    kw = dict(t_star=4.0, radius_m=300e3, buckets=(128, 256), dtype=np.float64)
    (a,), (b,) = gather_neighborhoods(train, cells, **kw), gather_neighborhoods(train, cells, **kw)
    np.testing.assert_array_equal(a.x, b.x)
    JD._permute_valid_points(a)
    TD._permute_valid_points(b)
    assert not np.array_equal(a.x, gather_neighborhoods(train, cells, **kw)[0].x)
    np.testing.assert_array_equal(b.x, a.x)
    np.testing.assert_array_equal(b.z, a.z)
    np.testing.assert_array_equal(b.mask, a.mask)


def test_load_hypers(tmp_path):
    ds = make_tiny_dataset()
    hyp = _hypers(ds)
    path = tmp_path / "h.npz"
    np.savez(path, **hyp)
    got = TD.load_hypers(str(path))
    for k in TD.HYPER_NAMES:
        np.testing.assert_array_equal(got[k], hyp[k])
        assert got[k].dtype == np.float64
    with pytest.raises(ValueError, match="missing"):
        TD.load_hypers({k: v for k, v in hyp.items() if k != "sn2"})


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke.py, imports without JAX, the
    JAX package, h5py (which only the quicklook NetCDFs need) or matplotlib
    (which only ``cell --figure`` needs)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import optimalinterpolation_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):  # the CLI entry runs on import\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "need = [p.__name__ + '.' + m for m in ('pipeline.multiday', 'pipeline.season', "
        "'io.quicklook', 'data.projection', 'models.nystroem', 'models.svgp', 'models.bfgs', "
        "'viz', 'parallel.mesh')]\n"
        "assert all(m in sys.modules for m in need), need\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'optimalinterpolation_tpu', 'h5py', 'matplotlib'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
