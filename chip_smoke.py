#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

Run from the root of the repository: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``, imports nothing of JAX, and prints one JSON line per
phase:

  1. device  torch sees a card; nvidia-smi's name and power limit; TF32 off.
  2. build   K1 and K2 compiled from csrc/ (seconds, ptxas register lines).
  3. K1      1,024 random SPD blocks plus one non-PD block, against the
             float64 twin: |L L^T - D|_max <= 1e-5 |D|_max, logdet within
             1e-4 relative, ok identical; kernel and float32-twin times.
  4. K2      N = 512 and 1024, B = 64 (one cell with NaN hypers), against the
             float64 twin: |d mean|, |d std| <= 1e-4 m (the whole-flow float32
             tolerance of tests/test_reference_flow.py), lZ within 1e-4
             relative, ok identical, the NaN cell NaN in both.
  5. slice   the quicklook day through ``cli.main(["daily", ..., "--hypers",
             H])`` on a synthetic 25 km season (320 x 320 grid, 300 km / 9-day
             window, buckets 512-4096): 15 keys, every active cell finite, K1
             and K2 launched, 64 cells of each bucket within 1e-4 m of the
             float64 twin; per-bucket walls and cells/s; rmse vs the
             synthetic truth.

Then a ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line; nothing is caught.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def _fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _phase(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        _fail("TF32 is on")
    print(smi, flush=True)
    _phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
           nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build() -> None:
    from optimalinterpolation_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    lib = _cuda.build()
    secs = time.perf_counter() - t0
    log = lib.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    _phase("build", seconds=secs, library=str(lib.name), ptxas=ptxas)


def phase_k1() -> dict:
    from optimalinterpolation_tpu_torch.ops import blocked_gp

    rng = np.random.default_rng(0)
    g = rng.standard_normal((1025, 128, 128))
    d64 = g @ g.transpose(0, 2, 1) / 128 + 0.5 * np.eye(128)
    d64[-1] -= 3.0 * np.eye(128)  # eigenvalues of the last block reach below 0
    d64 = 0.5 * (d64 + d64.transpose(0, 2, 1))
    d = torch.tensor(d64, dtype=torch.float32, device="cuda")

    l, w, logdet, ok = blocked_gp._factor_invert(d)
    torch.cuda.synchronize()
    lt, wt, logdet_t, ok_t = blocked_gp._factor_invert_plain(d.double())
    if not torch.equal(ok.cpu(), ok_t.cpu()):
        _fail(f"K1 ok flags differ from the twin: {ok.cpu().tolist()[-3:]} vs "
              f"{ok_t.cpu().tolist()[-3:]}")
    if bool(ok[-1]) or not bool(ok[:-1].all()):
        _fail("K1 ok flags wrong: the SPD blocks must pass and the non-PD block fail")
    good = ok
    dd = d.double()[good]
    l64 = l.double()[good]
    recon = (l64 @ l64.mT - dd).abs().max().item() / dd.abs().max().item()
    eye = torch.eye(128, dtype=torch.float64, device="cuda")
    inv = (w.double()[good] @ l64 - eye).abs().max().item()
    ld_rel = ((logdet.double() - logdet_t)[good].abs() / logdet_t[good].abs()).max().item()
    l_err = (l64 - lt[good]).abs().max().item()
    if not recon <= 1e-5:
        _fail(f"K1 |L L^T - D|_max / |D|_max = {recon} > 1e-5")
    if not inv <= 1e-4:
        _fail(f"K1 |W L - I|_max = {inv} > 1e-4")
    if not ld_rel <= 1e-4:
        _fail(f"K1 logdet relative error {ld_rel} > 1e-4")
    ms = _ms(lambda: blocked_gp._factor_invert(d), 20)
    plain_ms = _ms(lambda: blocked_gp._factor_invert_plain(d), 20)
    _phase("K1", blocks=int(d.shape[0]), recon_rel=recon, w_l_minus_i=inv, logdet_rel=ld_rel,
           max_abs_err_l=l_err, ms=ms, plain_ms=plain_ms)
    return {"max_abs_err": l_err, "ms": ms, "plain_ms": plain_ms}


def _k2_problem(rng, b: int, n: int):
    """Inputs like tests/test_pallas_gp.py::_problem, plus a NaN-hyper cell."""
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.1, 0.05, (b, n))
    mask = (rng.random((b, n)) < 0.85).astype(np.float64)
    h = np.tile(np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]), (b, 1))
    h[1] += 0.3
    h[-1] = np.nan
    xs = rng.uniform(-1e5, 1e5, (b, 3)) * np.asarray([1, 1, 0]) + np.asarray([0.0, 0.0, 4.0])
    mean = np.full((b,), 0.15)
    return [torch.tensor(a, dtype=torch.float32, device="cuda") for a in (h, x, y, xs, mask, mean)]


def _deviation(r, ref):
    """(max |d mean|, max |d std|, max relative d lZ) over ref's ok cells."""
    ok = ref.ok
    dm = (r.mean.double() - ref.mean)[ok].abs().max().item()
    ds = (r.std.double() - ref.std)[ok].abs().max().item()
    dl = ((r.lZ.double() - ref.lZ)[ok].abs() / ref.lZ[ok].abs()).max().item()
    return dm, ds, dl


def phase_k2() -> dict:
    from optimalinterpolation_tpu_torch.ops import fused_gp

    rng = np.random.default_rng(1)
    report = {"max_abs_err": 0.0}
    for n in (512, 1024):
        args = _k2_problem(rng, 64, n)
        r = fused_gp.gp_predict(*args, jitter=1e-6)
        torch.cuda.synchronize()
        ref = fused_gp.gp_predict_plain(*[a.double() for a in args], jitter=1e-6)
        twin32 = fused_gp.gp_predict_plain(*args, jitter=1e-6)
        if not torch.equal(r.ok, ref.ok):
            _fail(f"K2 N={n}: ok flags differ from the twin")
        if bool(ref.ok[-1]) or not bool(ref.ok[:-1].all()):
            _fail(f"K2 N={n}: the twin's ok flags are wrong")
        for t in (r.mean, r.std, r.lZ, ref.mean, ref.std, ref.lZ):
            if not torch.isnan(t[-1]):
                _fail(f"K2 N={n}: the NaN-hyper cell is not NaN")
        dm, ds, dl = _deviation(r, ref)
        tm, ts, tl = _deviation(twin32, ref)
        if not (dm <= 1e-4 and ds <= 1e-4 and dl <= 1e-4):
            _fail(f"K2 N={n}: |d mean| {dm}, |d std| {ds}, rel d lZ {dl} vs the float64 twin")
        ms = _ms(lambda: fused_gp.gp_predict(*args, jitter=1e-6), 10)
        plain_ms = _ms(lambda: fused_gp.gp_predict_plain(*args, jitter=1e-6), 10)
        _phase("K2", n=n, cells=64, d_mean=dm, d_std=ds, d_lz_rel=dl,
               twin32_d_mean=tm, twin32_d_std=ts, twin32_d_lz_rel=tl, ms=ms, plain_ms=plain_ms)
        report["max_abs_err"] = max(report["max_abs_err"], dm, ds)
        report.update(ms=ms, plain_ms=plain_ms)  # the N = 1024 times are kept
    return report


class _BucketLog(logging.Handler):
    """Collects the daily pipeline's per-bucket records (N, cells, tile, s)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.buckets = []

    def emit(self, record):
        self.buckets.append(record.args)


def phase_slice() -> dict:
    from optimalinterpolation_tpu_torch import cli
    from optimalinterpolation_tpu_torch.data.neighbors import gather_neighborhoods
    from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season
    from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season
    from optimalinterpolation_tpu_torch.data.window import flatten_window
    from optimalinterpolation_tpu_torch.io.pickles import load_pickle
    from optimalinterpolation_tpu_torch.ops import blocked_gp, fused_gp
    from optimalinterpolation_tpu_torch.pipeline.daily import DailyConfig

    res_km, n_days, day = 25, 9, 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        # bench.py's synthetic season: seed 7, tracks (10, 3, 8, 8), noise 0.1
        make_synthetic_season(tmp, grid_res_km=res_km, n_days=n_days, seed=7,
                              tracks_per_day=(10, 3, 8, 8), noise_std=0.1)
        synth_s = time.perf_counter() - t0
        g = np.load(os.path.join(tmp, f"x_{res_km}km.npy")).shape[0]
        hyp = os.path.join(tmp, "hypers.npz")
        values = dict(ell_x=2e5, ell_y=2e5, ell_t=2.0, sf2=0.03, sn2=0.005)
        np.savez(hyp, **{k: np.full((g, g), v) for k, v in values.items()})

        handler = _BucketLog()
        log = logging.getLogger("optimalinterpolation_tpu_torch.pipeline.daily")
        log.addHandler(handler)
        log.setLevel(logging.INFO)
        argv = ["daily", "--datapath", tmp, "--grid-res", str(res_km), "--day", str(day),
                "--prior-mean", "0.15", "--hypers", hyp, "--outdir", tmp]
        blocked_gp._factor_invert.launches = 0
        fused_gp.gp_predict.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        torch.cuda.synchronize()
        day_s = time.perf_counter() - t0
        launches = {"K1": blocked_gp._factor_invert.launches, "K2": fused_gp.gp_predict.launches}
        log.removeHandler(handler)
        line = json.loads(out.getvalue().strip().splitlines()[-1])

        res = load_pickle(line["output"])
        date = line["date"]
        if len(res) != 15:
            _fail(f"the pickle has {len(res)} keys, not 15")
        ds = read_freeboard_season(tmp, res_km, "2018-2019")
        cfg = DailyConfig()
        sie = ds.sie[:, :, day + cfg.t_mid]
        active = np.isfinite(sie)
        for key in ("interp", "interp_error", "lZ", "interp_smth", "interp_error_smth"):
            field = res[f"{date}_{key}"]
            if not np.isfinite(field[active]).all():
                _fail(f"{key}: {int((~np.isfinite(field[active])).sum())} active cells not finite")
        if launches["K1"] == 0 or launches["K2"] == 0:
            _fail(f"the slice did not launch both kernels: {launches}")
        fyi = np.load(os.path.join(tmp, f"CS2_FYI_synthetic_{res_km}km.npy"))
        truth = fyi[:, :, day + cfg.t_mid] + 0.02  # the synthetic FYI file is truth - 0.02 m
        fs = res[f"{date}_interp_smth"]
        rmse = float(np.sqrt(np.mean((fs[active] - truth[active]) ** 2)))

        # 64 cells of each bucket again, through the float64 twin on the card
        train = flatten_window(ds.obs[:, :, :, day:day + cfg.window_days], ds.x, ds.y)
        active_ij = np.nonzero(active)
        cells_xy = np.stack([ds.x[active_ij], ds.y[active_ij]], axis=1)
        batches = gather_neighborhoods(train, cells_xy, t_star=float(cfg.t_mid),
                                       radius_m=cfg.radius_km * 1e3, dtype=np.float32)
        lh = torch.tensor(np.log([values[k] for k in ("ell_x", "ell_y", "ell_t", "sf2", "sn2")]),
                          dtype=torch.float32)
        check = {}
        for b in batches:
            rows = np.nonzero(b.cell_index >= 0)[0][:64]
            ci = b.cell_index[rows]
            gi, gj = active_ij[0][ci], active_ij[1][ci]
            dm = ds_ = 0.0
            step = 16 if b.capacity >= 2048 else 64
            for s in range(0, len(rows), step):
                r = rows[s:s + step]
                f32 = [torch.from_numpy(a[r]) for a in (b.x, b.z, b.xstar, b.mask)]
                args = [lh.expand(len(r), 5), f32[0], f32[1], f32[2], f32[3],
                        torch.full((len(r),), 0.15, dtype=torch.float32)]
                ref = fused_gp.gp_predict_plain(*[a.double().cuda() for a in args], jitter=1e-6)
                if not bool(ref.ok.all()):
                    _fail(f"N={b.capacity}: the float64 twin failed to factor a cell")
                sl = slice(s, s + len(r))
                dm = max(dm, float(np.max(np.abs(fs[gi[sl], gj[sl]] - ref.mean.cpu().numpy()))))
                es = res[f"{date}_interp_error_smth"][gi[sl], gj[sl]]
                ds_ = max(ds_, float(np.max(np.abs(es - ref.std.cpu().numpy()))))
            if not (dm <= 1e-4 and ds_ <= 1e-4):
                _fail(f"N={b.capacity}: |d mean| {dm}, |d std| {ds_} vs the float64 twin > 1e-4 m")
            check[b.capacity] = (len(rows), dm, ds_)

    buckets = []
    for n, cells, tile, wall in handler.buckets:
        buckets.append({"n": n, "cells": cells, "tile": tile, "wall_s": wall,
                        "cells_per_s": cells / wall, "checked": check[n][0],
                        "d_mean_vs_f64": check[n][1], "d_std_vs_f64": check[n][2]})
    predict_s = sum(b["wall_s"] for b in buckets)
    _phase("slice", date=date, grid=g, active_cells=int(active.sum()), synth_s=synth_s,
           day_wall_s=day_s, predict_wall_s=predict_s,
           cells_per_s_predict=int(active.sum()) / predict_s,
           cells_per_s_day=int(active.sum()) / day_s, rmse_vs_truth_m=rmse,
           launches=launches, buckets=buckets,
           peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False")
    phase_device()
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    launches = phase_slice()
    kernels = [
        {"name": "K1 factor_invert_128", "route": "cuda",
         "source": "optimalinterpolation_tpu_torch/csrc/k1_factor_invert.cu",
         "replaces": "optimalinterpolation_tpu/ops/blocked_gp.py:80",
         "launches": launches["K1"], **k1},
        {"name": "K2 fused predict", "route": "cuda",
         "source": "optimalinterpolation_tpu_torch/csrc/k2_predict.cu",
         "replaces": "optimalinterpolation_tpu/ops/pallas_gp.py:795",
         "launches": launches["K2"], **k2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
