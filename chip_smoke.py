#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

Run from the root of the repository: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``, imports nothing of JAX, and prints one JSON line per
phase:

  1. device  torch sees a card; nvidia-smi's name and power limit; TF32 off.
  2. build   K1, K2 and K3 compiled from csrc/ (seconds, ptxas register lines;
             0 spill bytes in each of the four kernels; HMMA tensor-core
             instructions in the SASS of K2 and both K3 variants, counted by
             cuobjdump), and the host data plane (native/oi_native.cpp) by
             g++.
  3. K1      1,024 random SPD blocks plus one non-PD block, against the
             float64 twin: |L L^T - D|_max <= 1e-5 |D|_max, |W L - I|_max <=
             1e-4, logdet within 1e-4 relative, ok identical; the day's
             Matern-3/2 diagonal and Schur-complemented blocks at the larger
             of those gates and 4 x the float32 twin's deviation, two
             launches bit-equal; identity exact; bad pivots in panels 0 and
             3 not ok; kernel, float32-twin and library times at 1, 132, 352
             (a launch of the 2048 bucket) and 1,025 blocks, the kernel no
             slower than the library at 352 and 1,025.
  4. K2      N = 128, 256, 512 and 1024, B = 64 (one cell with NaN hypers),
             against the float64 twin: |d mean|, |d std| <= 1e-4 m (the
             whole-flow float32 tolerance of tests/test_reference_flow.py), lZ
             within 1e-4 relative, ok identical, the NaN cell NaN in both.
  5. K3      value and gradient at N = 128 (all four kernel families), 256,
             512 and 1024, B = 132 (one cell per SM; masked rows, differing
             hypers, one all-padding row, one NaN row) against the float64
             twin: value within 1e-5 relative, gradient within
             max(1e-3 |g|_inf, 4 x the float32 twin's own deviation); at
             N = 1024 the value of 1 and 8 rows (a line-search launch),
             bit-equal to those rows of the 132-row launch, with times.
  6. slice   the quicklook day through ``cli.main(["daily", ..., "--hypers",
             H])`` on a synthetic 25 km season (320 x 320 grid, 300 km / 9-day
             window, buckets 512-4096): 15 keys, every active cell finite, K1
             and K2 launched, 64 cells of each bucket within 1e-4 m of the
             float64 twin; per-bucket walls and cells/s; rmse vs the
             synthetic truth.
  7. fit     the full two-pass day through ``cli.main(["daily", ...])``
             without ``--hypers`` on the same season: seed pass, per-cell
             L-BFGS fit through K3, predict, smoothing, second predict. 15
             keys, every active cell finite in every field, K1, K2 and both
             K3 variants launched; for 64 cells of each bucket the pass-2
             prediction within 1e-4 m of the float64 twin at the pickle's
             smoothed hypers, and the float64 NLL at the fitted hypers
             against what a float64 fit reaches from there (median <= 0.05
             nats, mean <= 0.7; K3's fit against the float32 twin's from one
             start, p95 <= 0.05); a histogram of rows per K3 value launch.

  8. objectives  K3, the blocked objective and the rank-512 Nystrom objective
             on the day's cells: value and value + gradient times at N = 1024
             (132, 8 and 1 rows) and, blocked and Nystrom, at N = 2048 and
             4096 (16 rows), each beside its bound and the K1 launches of one
             evaluation; both new objectives in float32 against float64 on
             the CPU (value 1e-5 relative, gradient 1e-3 relative in norm) and
             a row's value in a 1-row and the 132-row evaluation (bit-equal
             recorded, 1e-6 relative gated); peak memory a row against the
             pipeline's chunk models; the fine stage at N = 1024 fitted under
             each objective from one warm start (1,024 cells: wall,
             iterations, evaluations, launches, converged share, float64
             exact-NLL cost and exact-prediction deviations against the K3
             fit, rmse vs the truth), K1 launched and K3 not by the new ones;
             and the thresholds ``"auto"``'s rule gives, beside the defaults.
  9. season  ``pipeline.season.run_season`` on a second synthetic season (the
             same parameters, 12 days: windows 0-3) in strided waves of two
             days: wave 0 windows 0 and 2, cold and spatially seeded; wave 1
             windows 1 and 3, each started from its predecessor's fit; each
             day's pickle and quicklook NetCDF written. Per wave: cells, wall
             (first gather to last file), cells/s, the stage entries,
             launches, K3 value launches by rows, host synchronisations,
             peak memory, and the host seconds outside the stages (gather,
             window, nearest fill, pickle, NetCDF); per NetCDF its bytes and
             write seconds. Fails unless every NetCDF, read back by
             ``read_quicklook``, holds its pickle's ``interp_smth.T`` and
             ``interp_error_smth.T`` and the grid's lat / lon transposed, bit
             for bit with NaNs in place, under a title that starts with the
             date, every pickle has 15 keys with every active cell finite, 64
             cells of each bucket of each day are within 1e-4 m of the
             float64 twin at the pickle's smoothed hypers, every day meets
             the fit phase's optimum gates on the rows its wave fitted, K1, K2 and both K3 variants
             ran, the chained wave ran no seed pass and no cascade, and a
             second call on the same directory resumes all four days with
             no launch at all. rmse vs the truth per day.
 10. chain   the production chain around the day, on the season phase's
             season: (a) windows 0-3 gathered by ``gather_neighborhoods``
             (the native grid hash, buckets filled by array indexing) and by
             its plain version (SciPy's kd-tree, filled cell by cell as the
             JAX package fills them), every array equal, seconds of each
             beside the season waves' gather seconds; (b) ``bin`` on seeded
             .proc files (2 days x 10 tracks x 20,000 rows, invalid flags,
             out-of-range freeboards, nan tokens): fields equal to the
             plain path (np.genfromtxt + bin_points) at NaNs in the same
             places and rtol 1e-9, parse seconds native against genfromtxt;
             (c) ``hypers`` over the four season pickles (4 days, finite
             cells) and regridded onto a 50 km grid with the built-in ocean
             mask; (d) the quicklook day through ``cli.main(["daily", ...,
             "--hypers", H, "--prior-background", "9", "--profile", LOGDIR,
             "--quicklook"])`` at full width: its NetCDF as the season
             phase's are checked, 15 keys, every active cell finite, K1 and K2
             launched and K3 not, 64 cells of each bucket within 1e-4 m of
             the float64 twin at those hypers and that prior field, and the
             Chrome trace under LOGDIR naming K1's and K2's kernels, with
             their summed device ms; (e) ``validate`` on the truth at every
             active cell of the four dates: its rmse within 1e-6 m of the
             pooled rmse computed from the pickles directly.
 11. cell    the ``cell`` command (``cli.main(["cell", ...])``) on the fit
             phase's season at two cells of window 0: the active cell with the
             most points in the 1024 bucket and the first cell of the 4096
             bucket. ``exact`` at both (L-BFGS through K3, and through the
             rank-512 Nystrom objective on K1: each launched, the other not),
             ``exact --optimizer adam`` at the first (60 K3 value + gradient
             launches and one value), ``nystroem --landmarks 925`` (BFGS, 60
             iterations) and ``svgp`` (50 inducing points, 10,000 steps of
             100) at the first. Gates: each exact prediction within 1e-4 m of
             the float64 ``exact_gp.predict`` on the CPU at the printed
             hypers; the L-BFGS fits' float64 NLL of their objective within
             NLL_MEAN of a float64 fit from there; Nystrom's mean and std
             finite and within max(1e-3 m, 4 x the float32 CPU twin's
             deviation) of float64 ``nystroem_predict`` at the same hypers and
             landmarks; Nystrom's and SVGP's mean within 0.05 m of the exact
             mean, std > 0, a finite ELBO. Seconds by method, ms a SVGP step.
 12. adam    the fit phase's full day through ``cli.main(["daily", ...,
             "--optimizer", "adam"])`` (60 steps, nothing cut): 15 keys, every
             active cell finite in every field, K1, K2 and both K3 variants
             launched, no seed pass and no cascade; for 64 cells of each
             bucket the pass-2 prediction within 1e-4 m of the float64 twin,
             and the float64 value of the routed objective at the day's
             hypers against a float64 Adam run of the same cells from x0
             (median <= 0.05, mean <= 0.7 nats). Day wall, cells/s, stage
             walls, launches, peak memory, rmse beside the L-BFGS day's.
 13. devices ``cell_sharding`` (``parallel/mesh.py``): (a) the fit phase's
             day through ``interpolate_daily(..., cell_sharding=
             cell_sharding(make_mesh(devices=["cuda:0", "cuda:0"])))``, two
             host threads and two streams on one card, at the fit phase's
             configuration: the five hyper fields bit-equal to the fit
             phase's, every other field within 1e-6 m (1e-6 relative for lZ
             and the smoothed hypers), each field's largest deviation and
             bit-equality printed, rmse within 1e-6 m, K1, K2 and both K3
             variants launched on each shard's stream; the merged stage
             entries, day, fit and predict walls, host syncs (also by
             shard), each shard's wall, peak memory and a probe of the
             interpreter lock's wait, beside the fit phase's one-shard
             numbers. (b) The slice phase's quicklook day on the same two
             shards: within 1e-6 m of the slice phase, K1 and K2 on each
             shard's stream, K3 not. (c) With two or more cards, the day
             through ``cli.main(["daily", ..., "--devices", N])`` over all
             N, with (a)'s gates; on one card ``"multi_card": "not run: 1
             card"``.
 14. knobs   the fit phase's day through the same ``cli.main(["daily", ...])``
             call with the environment knobs ``OI_BUCKET_128=1
             OI_BUCKET_256=1 OI_CASCADE_NYS_M=256`` set after import (and
             unset after): six buckets, so K2 and K3 run at N = 128 and 256
             inside the pipeline, and the cascade stages at n = 512 launch on
             the rank-256 Nystrom objective (K1) while every fine stage stays
             on K3. The fit phase's gates (15 keys, every active cell finite,
             64 cells of each of the six buckets within 1e-4 m of the float64
             twin, the optimum gates), plus: each cascade stage at n = 512
             Nystrom rank 256 with K1 launched inside it, every fine stage
             K3, K2 and K3 launched at N = 128 and 256 (launches by stage).
             Cells by bucket, walls, K3 rows a launch, host syncs, peak
             memory, rmse vs the truth beside the fit phase's (recorded, not
             gated). The fit phase, run first with no knob set, is the check
             that unset knobs change nothing.
 15. northstar  ``bench.py``'s calibration day, rebuilt with the port's own
             modules (``tools/north_star.py``): its 16-day synthetic season,
             day 0, the cells that ``default_rng(1).random(...) > 0.12``
             leaves active (2,086 exactly),
             its ``DailyConfig`` (50 iterations, grad_tol and ftol 1e-3,
             jitter 1e-6), prior 0.15 and its score (rmse of the finite
             ``interp_smth`` cells against the FYI file + 0.02 m), through
             ``interpolate_daily`` under the JAX package's routing
             (``OI_BLOCKED_MIN_N=512 OI_NYSTROEM_MIN_N=1024``: the 512 bucket
             blocked on K1, N = 1024 Nystrom rank 512 on K1) and the port's.
             Gates: 15 keys, every active cell finite, the JAX routing's
             stages on their objectives, and rmse against the JAX package's
             recorded 0.0120 m (DESIGN.md, round-5 table): within 0.55 mm
             under the JAX routing (0.5 mm plus the recorded value's
             rounding), at most 0.0120 + 0.00055 m under the port's.
             ``tools/north_star_day.py`` runs the full-scale day (17,149
             cells, 0.0116 m) with the same gates.
 16. season_cli  the ``season`` command itself, ``cli.main(["season", ...,
             "--hypers", H, "--days", "0:2", "--day-parallel", "2"])`` on the
             season phase's season at the chain phase's seasonal hypers (25
             km, 320 x 320, predict only, one wave of two days): 2 pickles
             and 2 NetCDFs, each NetCDF checked as the season phase's, every
             active cell finite, K1 and K2 launched and K3 not; a second
             identical call resumes both days with no launch and no file
             rewritten. Wall, cells/s, NetCDF seconds and bytes.

Phases 9, 10 and 16 run with ``sys.modules["h5py"] = None``, so every
NetCDF is written and read by ``io/hdf5.py`` even where h5py is installed.

The fit phase's day must also give an earlier run's launches and rmse to
the bit (``EARLIER_FIT``): the gather's arrays do not depend on how it
searches. Then a ``{"phase": "seconds", ...}`` line with each phase's wall,
a ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line; nothing is caught.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tools import north_star


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


# NVIDIA's data sheet for the H100 SXM: float32 outside the tensor cores, TF32
# on them (dense), and the device-memory rate. One TF32 product is ruled out
# in Cholesky chains; the 3xTF32 split does three.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12


def _bound(n_bytes: float, flops: float, tf32x3: bool = False) -> dict:
    """The least milliseconds the card could take: the bytes the function
    must move (inputs read once, outputs written once) over the memory rate,
    or its operations over the peak of the route, whichever is larger. With
    ``tf32x3`` the operations may also take the 3xTF32 route (three products
    at the TF32 peak), and the faster route counts; the float32 (SIMT) figure
    stays beside it as ``bound_simt_ms``."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_simt = flops / PEAK_FP32_FLOPS * 1e3
    t_ops = min(t_simt, 3 * flops / PEAK_TF32_FLOPS * 1e3) if tf32x3 else t_simt
    out = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if tf32x3:
        out.update(bound_simt_ms=max(t_bytes, t_simt),
                   bound_route="3xTF32" if t_ops < t_simt else "float32")
    return out


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
    from optimalinterpolation_tpu_torch import native
    from optimalinterpolation_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    lib = _cuda.build()
    secs = time.perf_counter() - t0
    log = lib.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    spills = [ln for ln in ptxas if "spill" in ln]
    # K1, K2 and both K3 variants, each with 0 spill bytes
    if len(spills) != 4 or any(", 0 bytes spill stores, 0 bytes spill loads" not in ln
                               for ln in spills):
        _fail(f"ptxas reports spills or not four kernels: {spills}")
    hmma = _hmma_counts(lib)
    if len(hmma) != 4 or any(hmma[k] == 0 for k in ("K2", "K3 value", "K3 grad")):
        _fail(f"K2 and both K3 variants must run their tile products on the tensor cores: "
              f"HMMA lines {hmma}")
    t0 = time.perf_counter()
    host_lib = native.build()  # the host data plane, with g++
    _phase("build", seconds=secs, library=str(lib.name), ptxas=ptxas, hmma_lines=hmma,
           native_library=host_lib.name, native_seconds=time.perf_counter() - t0)


def _hmma_counts(lib) -> dict:
    """Tensor-core (HMMA) instructions in each kernel's SASS, by
    ``cuobjdump -sass`` on the built library."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    names = {"k1_factor_invert_kernel": "K1", "k2_predict_kernel": "K2",
             "k3_nll_kernelILb0": "K3 value", "k3_nll_kernelILb1": "K3 grad"}
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = next((v for k, v in names.items() if k in m.group(1)), m.group(1))
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def _k1_errors(d, l, w, logdet, ref_logdet) -> dict:
    """|L L^T - D|_max / |D|_max, |W L - I|_max and the largest logdet error
    relative to max(|logdet|, 1), in float64 over the batch."""
    dd, l64 = d.double(), l.double()
    eye = torch.eye(128, dtype=torch.float64, device=d.device)
    return {"recon_rel": ((l64 @ l64.mT - dd).abs().max() / dd.abs().max()).item(),
            "w_l_minus_i": (w.double() @ l64 - eye).abs().max().item(),
            "logdet_rel": ((logdet.double() - ref_logdet).abs()
                           / ref_logdet.abs().clamp_min(1.0)).max().item()}


def _matern_blocks(day) -> torch.Tensor:
    """Diagonal 128-blocks of 16 real cells of the day's 2048 bucket,
    Matern-3/2 at the slice's hypers (sn2 / sf2 = 0.17), jitter 1e-6, padding
    rows identity, plus each cell's last diagonal block after 15 Schur
    complement steps (the block the blocked Cholesky factors last), all
    formed in float64 and rounded to float32."""
    from optimalinterpolation_tpu_torch.ops import blocked_gp
    from optimalinterpolation_tpu_torch.ops.kernels import Kernel

    b = next(bb for bb in day.batches if bb.capacity == 2048)
    rows = np.nonzero(b.cell_index >= 0)[0][:16]
    x, m = (torch.from_numpy(a[rows]).double().cuda() for a in (b.x, b.mask))
    h = torch.log(torch.tensor([2e5, 2e5, 2.0, 0.03, 0.005], dtype=torch.float64,
                               device="cuda")).expand(len(rows), 5)
    a, _ = blocked_gp._build_a(h, x, m, Kernel.MATERN32, 1e-6)
    ab = blocked_gp._to_blocks(a, 128)
    diag = ab.diagonal(dim1=1, dim2=2).permute(0, 3, 1, 2).reshape(-1, 128, 128)
    lk = torch.linalg.cholesky(a)[:, -128:, -128:]
    return torch.cat([diag, lk @ lk.mT]).float().contiguous()


def phase_k1(day) -> dict:
    """K1 against its float64 twin on two block sets: random SPD blocks
    (gates: |L L^T - D|_max <= 1e-5 |D|_max, |W L - I|_max <=
    1e-4, logdet within 1e-4 relative) and the day's Matern blocks (each gate
    the larger of those and 4 x the float32 twin's own deviation on the same
    blocks, as K3's gradient gate); ok flags identical; an identity block
    exactly L = W = I, logdet 0; non-PD blocks with bad pivots in panel 0
    and 3, or in 3 alone, not ok; two launches bit-equal. Times at 1 block
    (the latency K2 and K3 pay per diagonal step), 132 (one block per SM),
    352 (a launch of the 2048 bucket) and 1,025."""
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
    err = _k1_errors(d[good], l[good], w[good], logdet[good], logdet_t[good])
    l_err = (l.double()[good] - lt[good]).abs().max().item()
    gates = {"recon_rel": 1e-5, "w_l_minus_i": 1e-4, "logdet_rel": 1e-4}
    for k, tol in gates.items():
        if not err[k] <= tol:
            _fail(f"K1 random SPD: {k} = {err[k]} > {tol}")

    # the day's Matern blocks, against the float64 and the float32 twin
    dm = _matern_blocks(day)
    out = blocked_gp._factor_invert(dm)
    again = blocked_gp._factor_invert(dm)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        _fail("K1: two launches on the same blocks differ")
    ref = blocked_gp._factor_invert_plain(dm.double())
    twin = blocked_gp._factor_invert_plain(dm)
    if not (bool(out[3].all()) and bool(ref[3].all()) and bool(twin[3].all())):
        _fail("K1 Matern blocks: not every block factored")
    m_err = _k1_errors(dm, out[0], out[1], out[2], ref[2])
    m_twin = _k1_errors(dm, twin[0], twin[1], twin[2], ref[2])
    m_tol = {k: max(tol, 4.0 * m_twin[k]) for k, tol in gates.items()}
    for k, tol in m_tol.items():
        if not m_err[k] <= tol:
            _fail(f"K1 Matern blocks: {k} = {m_err[k]} > {tol}")
    m_l_err = (out[0].double() - ref[0]).abs().max().item()

    # identity, and non-PD blocks with bad pivots in panel 0 and 3 / 3 alone
    eye32 = torch.eye(128, dtype=torch.float32, device="cuda")
    le, we, lde, oke = blocked_gp._factor_invert(eye32[None].contiguous())
    if not (torch.equal(le[0], eye32) and torch.equal(we[0], eye32) and lde[0] == 0
            and bool(oke[0])):
        _fail("K1: the identity block does not give L = W = I, logdet 0 exactly")
    bad = d[:2].clone()
    bad[0, 5, 5] = -1.0
    bad[0, 100, 100] = -50.0
    bad[1, 100, 100] = -50.0
    ok_bad = blocked_gp._factor_invert(bad)[3]
    if bool(ok_bad.any()) or bool(blocked_gp._factor_invert_plain(bad.double())[3].any()):
        _fail(f"K1: blocks with non-positive pivots in panels 0 and 3 pass: {ok_bad.tolist()}")

    def library(blocks):
        # one PyTorch call pair for the same function; the port never calls
        # it on a CUDA tensor
        l_, _ = torch.linalg.cholesky_ex(blocks)
        return torch.linalg.solve_triangular(l_, eye32.expand_as(l_), upper=False)

    times = {}
    for nblk in (1025, 352, 132, 1):  # 352: one launch of the 2048 bucket's tiles
        dd_ = d[:nblk]
        reps = 20 if nblk > 132 else 200
        times[nblk] = {
            "ms": _ms(lambda: blocked_gp._factor_invert(dd_), reps),
            "plain_ms": _ms(lambda: blocked_gp._factor_invert_plain(dd_), reps),
            "library_ms": _ms(lambda: library(dd_), reps),
            # d read, L and W written; factor and inverse 128^3 / 3 FLOP each
            **_bound(nblk * (3 * 128 * 128 * 4 + 5), nblk * 2 * 128 ** 3 / 3),
        }
    for nblk in (1025, 352):
        if not times[nblk]["ms"] <= times[nblk]["library_ms"]:
            _fail(f"K1 at {nblk} blocks: {times[nblk]['ms']} ms, slower than the "
                  f"library pair's {times[nblk]['library_ms']} ms")
    _phase("K1", blocks=int(d.shape[0]), **err, max_abs_err_l=l_err,
           matern_blocks=int(dm.shape[0]), matern=m_err, matern_twin32=m_twin,
           matern_tol=m_tol, matern_max_abs_err_l=m_l_err,
           times={str(k): v for k, v in times.items()})
    return {"shape": "352 blocks of 128x128", "max_abs_err": max(l_err, m_l_err),
            **times[352], "times_by_blocks": {str(k): v for k, v in times.items()}}


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
    report = {"max_abs_err": 0.0, "by_n": {}}
    for n in (128, 256, 512, 1024):
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
        reps = 40 if n < 512 else 10
        ms = _ms(lambda: fused_gp.gp_predict(*args, jitter=1e-6), reps)
        plain_ms = _ms(lambda: fused_gp.gp_predict_plain(*args, jitter=1e-6), reps)
        # inputs and the (B, 5) output against N^3 / 3 FLOP of Cholesky per cell
        bound = _bound(64 * (5 * n + 14) * 4, 64 * n ** 3 / 3, tf32x3=True)
        _phase("K2", n=n, cells=64, d_mean=dm, d_std=ds, d_lz_rel=dl,
               twin32_d_mean=tm, twin32_d_std=ts, twin32_d_lz_rel=tl, ms=ms, plain_ms=plain_ms,
               **bound)
        report["max_abs_err"] = max(report["max_abs_err"], dm, ds)
        report["by_n"][str(n)] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max(dm, ds),
                                  **bound}
        # the N = 1024 times are kept at the top
        report.update(shape=f"N={n}, 64 cells", ms=ms, plain_ms=plain_ms, library_ms=None,
                      **bound)
    return report


def _k3_problem(rng, b: int, n: int):
    """Rows with masks and differing hypers; row 2 all padding, the last NaN."""
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.0, 0.05, (b, n))
    mask = (rng.random((b, n)) < 0.85).astype(np.float64)
    mask[2] = 0.0
    h = np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]) + rng.normal(0.0, 0.2, (b, 5))
    h[-1] = np.nan
    return [torch.tensor(a, dtype=torch.float32, device="cuda") for a in (h, x, y, mask)]


def phase_k3() -> dict:
    """Gate, fixed before the run: the value within 1e-5 relative of the
    float64 twin (float32 rounding of a sum of ~N terms of size |nll|/N);
    the gradient within max(1e-3 |g|_inf, 4 x the float32 twin's deviation),
    over the batch: each gradient entry is a difference of two traces that
    nearly cancel at an optimum, so float32 leaves an absolute error that
    scales with the traces, not with the entry, and the plain float32 twin
    on the same inputs shows how large that is."""
    from optimalinterpolation_tpu_torch.ops import fused_gp
    from optimalinterpolation_tpu_torch.ops.kernels import Kernel

    rng = np.random.default_rng(2)
    b = 132
    report, by_n = {}, {}
    cases = [(128, k) for k in Kernel] + [(n, Kernel.MATERN32) for n in (256, 512, 1024)]
    for n, kind in cases:
        args = _k3_problem(rng, b, n)
        kw = dict(kind=kind, jitter=1e-6)
        value = fused_gp.gp_nll(*args, **kw)
        nll, grad = fused_gp.gp_nll_and_grad(*args, **kw)
        torch.cuda.synchronize()
        ref_v, ref_g = fused_gp.gp_nll_and_grad_plain(*[a.double() for a in args], **kw)
        twin_v, twin_g = fused_gp.gp_nll_and_grad_plain(*args, **kw)
        if not torch.equal(value, nll):
            _fail(f"K3 N={n} {kind.value}: the value and gradient launches differ in the value")
        if not (torch.isinf(nll[-1]) and nll[-1] > 0 and torch.isnan(grad[-1]).all()
                and torch.isinf(ref_v[-1]) and torch.isnan(ref_g[-1]).all()):
            _fail(f"K3 N={n} {kind.value}: the NaN-hyper row is not (+inf, NaN)")
        if not (nll[2] == 0 and (grad[2] == 0).all()):
            _fail(f"K3 N={n} {kind.value}: the all-padding row is not (0, 0)")
        ok = slice(0, b - 1)
        if not torch.isfinite(ref_v[ok]).all():
            _fail(f"K3 N={n} {kind.value}: the float64 twin failed to factor a row")
        scale = ref_v[ok].abs().clamp_min(1.0)
        dv = ((nll.double() - ref_v)[ok].abs() / scale).max().item()
        tv = ((twin_v.double() - ref_v)[ok].abs() / scale).max().item()
        dg = (grad.double() - ref_g)[ok].abs().max().item()
        tg = (twin_g.double() - ref_g)[ok].abs().max().item()
        gmax = ref_g[ok].abs().max().item()
        tol = max(1e-3 * gmax, 4.0 * tg)
        if not dv <= 1e-5:
            _fail(f"K3 N={n} {kind.value}: value relative error {dv} > 1e-5")
        if not dg <= tol:
            _fail(f"K3 N={n} {kind.value}: gradient max |d| {dg} > {tol}")
        line = dict(n=n, kind=kind.value, cells=b, d_value_rel=dv, twin32_d_value_rel=tv,
                    d_grad=dg, twin32_d_grad=tg, grad_inf_norm=gmax, grad_tol=tol)
        if kind is Kernel.MATERN32:
            reps = 40 if n == 128 else 10 if n < 1024 else 5
            line.update(
                value_ms=_ms(lambda: fused_gp.gp_nll(*args, **kw), reps),
                ms=_ms(lambda: fused_gp.gp_nll_and_grad(*args, **kw), reps),
                plain_value_ms=_ms(lambda: fused_gp.gp_nll_plain(*args, **kw), reps),
                plain_ms=_ms(lambda: fused_gp.gp_nll_and_grad_plain(*args, **kw), reps),
            )
            # inputs and the (B, 6) output against N^3 FLOP per cell (Cholesky,
            # L^-T and the lower triangle of L^-T L^-1, N^3 / 3 each); the
            # value alone N^3 / 3
            bound = _bound(b * (5 * n + 11) * 4, b * float(n) ** 3, tf32x3=True)
            value_bound = _bound(b * (5 * n + 6) * 4, b * float(n) ** 3 / 3, tf32x3=True)
            line.update(**bound, value_bound_ms=value_bound["bound_ms"])
            by_n[str(n)] = {k: line[k] for k in ("kind", "ms", "value_ms", "plain_ms",
                                                 "plain_value_ms", "bound_ms", "bound_by",
                                                 "bound_simt_ms", "value_bound_ms")}
            by_n[str(n)]["max_abs_err"] = dg
            # the N = 1024 gradient launch is kept at the top
            report = dict(shape=f"N={n}, {b} cells, value + gradient", max_abs_err=dg,
                          value_rel_err=dv, ms=line["ms"], plain_ms=line["plain_ms"],
                          value_ms=line["value_ms"], library_ms=None, **bound)
        if n == 1024:
            report["value_ms_by_rows"] = _k3_few_rows(args, kw, value, line["value_ms"])
        _phase("K3", **line)
    report["by_n"] = by_n
    return report


def _k3_few_rows(args, kw, value, wave_ms) -> dict:
    """K3 value launches of 1 and 8 rows at N = 1024, the late line-search
    steps: each row bit-equal to the same row of the 132-row launch (a row's
    result does not depend on the rows beside it), and their times beside
    the full wave's."""
    from optimalinterpolation_tpu_torch.ops import fused_gp

    times = {"132": wave_ms}
    for rows in (1, 8):
        sub = [a[:rows].contiguous() for a in args]
        got = fused_gp.gp_nll(*sub, **kw)
        if not torch.equal(got, value[:rows]):
            _fail(f"K3 N=1024: a {rows}-row launch differs from those rows of the full launch")
        times[str(rows)] = _ms(lambda: fused_gp.gp_nll(*sub, **kw), 20)
    _phase("K3_rows", n=1024, value_ms_by_rows=times)
    return times


class _DailyLog(logging.Handler):
    """Collects the daily pipeline's INFO records: per predicted bucket
    ``(N, cells, tile rows, seconds)``, per stage a dict."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.buckets = []
        self.stages = []
        self.counts = []  # the launch counts when each stage's record came

    def emit(self, record):
        if isinstance(record.args, dict):
            self.stages.append(record.args)
            self.counts.append(_counts())
        else:
            self.buckets.append(record.args)

    def stage_launches(self) -> list:
        """Each stage's kernel launches: the counts at its record minus those
        at the record before (the first against 0, as ``_run_daily`` zeroes
        them). Exact for an unsharded day, whose stages run one by one."""
        prev = dict.fromkeys(KERNEL_NAMES, 0)
        out = []
        for c in self.counts:
            out.append({k: c[k] - prev[k] for k in KERNEL_NAMES})
            prev = c
        return out


RES_KM, N_DAYS, DAY, PRIOR = 25, 9, 0, 0.15
# Gates of the fit's optimum, in nats of float64 NLL (see _check_optimum).
NLL_TYPICAL = 0.05  # the typical (median) cell, and K3 against its float32 twin (p95)
NLL_MEAN = 0.7  # the mean exact-NLL cost the JAX package accepted for its default objective
HYPERS = ("ell_x", "ell_y", "ell_t", "sf2", "sn2")


def _run_daily(tmp: str, extra_argv: list, prior_argv=("--prior-mean", str(PRIOR))):
    """``cli.main(["daily", ...])`` on the season in ``tmp`` with every
    launch count at 0 before and read after. Returns (result dict, date,
    launch counts, host synchronisations, wall seconds, log handler)."""
    from optimalinterpolation_tpu_torch import cli
    from optimalinterpolation_tpu_torch.io.pickles import load_pickle
    from optimalinterpolation_tpu_torch.models import optimizer

    handler = _DailyLog()
    log = logging.getLogger("optimalinterpolation_tpu_torch.pipeline.daily")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    argv = ["daily", "--datapath", tmp, "--grid-res", str(RES_KM), "--day", str(DAY),
            *prior_argv, "--outdir", tmp, *extra_argv]
    _zero_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    log.removeHandler(handler)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    res = load_pickle(line["output"])
    if len(res) != 15:
        _fail(f"the pickle has {len(res)} keys, not 15")
    return res, line["date"], launches, optimizer._lbfgs_segment.host_syncs, wall, handler


class _Day:
    """A synthetic day's truth, active cells and neighborhood buckets,
    gathered once for the checks of a phase: window ``day`` of the season
    in ``tmp``."""

    def __init__(self, tmp: str, day: int = DAY):
        from optimalinterpolation_tpu_torch.data.neighbors import gather_neighborhoods
        from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season
        from optimalinterpolation_tpu_torch.data.window import flatten_window
        from optimalinterpolation_tpu_torch.pipeline.daily import DailyConfig

        self.cfg = cfg = DailyConfig()
        ds = read_freeboard_season(tmp, RES_KM, "2018-2019")
        self.date = ds.dates[day + cfg.t_mid]
        self.active = np.isfinite(ds.sie[:, :, day + cfg.t_mid])
        self.active_ij = np.nonzero(self.active)
        fyi = np.load(os.path.join(tmp, f"CS2_FYI_synthetic_{RES_KM}km.npy"))
        self.truth = fyi[:, :, day + cfg.t_mid] + 0.02  # the FYI file is truth - 0.02 m
        self.train = flatten_window(ds.obs[:, :, :, day:day + cfg.window_days], ds.x, ds.y)
        self.cells_xy = np.stack([ds.x[self.active_ij], ds.y[self.active_ij]], axis=1)
        self.batches = gather_neighborhoods(self.train, self.cells_xy, t_star=float(cfg.t_mid),
                                            radius_m=cfg.radius_km * 1e3, dtype=np.float32)

    def cell(self, xy):
        """The neighbourhood the ``cell`` command gathers at ``xy``: its one
        row's (x, z, mask, xstar), float32, in the gather's order."""
        from optimalinterpolation_tpu_torch.data.neighbors import gather_neighborhoods

        (b,) = gather_neighborhoods(self.train, np.asarray([xy]), t_star=float(self.cfg.t_mid),
                                    radius_m=self.cfg.radius_km * 1e3, batch_multiple=1,
                                    dtype=np.float32)
        return b.x[0], b.z[0], b.mask[0], b.xstar[0]

    def rows(self, b):
        """The first 64 real rows of a bucket and their grid indices."""
        rows = np.nonzero(b.cell_index >= 0)[0][:64]
        ci = b.cell_index[rows]
        return rows, self.active_ij[0][ci], self.active_ij[1][ci]

    def rmse(self, field) -> float:
        return float(np.sqrt(np.mean((field[self.active] - self.truth[self.active]) ** 2)))

    def check_finite(self, res, date, keys):
        for key in keys:
            field = res[f"{date}_{key}"]
            if not np.isfinite(field[self.active]).all():
                _fail(f"{key}: {int((~np.isfinite(field[self.active])).sum())} active cells "
                      "not finite")

    def check_predict(self, res, date, hyper_suffix: str, prior_cells=None) -> dict:
        """64 cells of each bucket again through the float64 twin on the
        card, at the hypers the pickle holds and the prior mean ``PRIOR``
        or, where given, ``prior_cells`` (one per active cell): {N: (cells,
        |d mean|, |d std|)}."""
        from optimalinterpolation_tpu_torch.ops import fused_gp

        if prior_cells is None:
            prior_cells = np.full(len(self.active_ij[0]), PRIOR)

        fs, es = res[f"{date}_interp_smth"], res[f"{date}_interp_error_smth"]
        check = {}
        for b in self.batches:
            rows, gi, gj = self.rows(b)
            lh = np.log(np.stack([res[f"{date}_{k}{hyper_suffix}"][gi, gj] for k in HYPERS], 1))
            dm = ds_ = 0.0
            step = 16 if b.capacity >= 2048 else 64
            for s in range(0, len(rows), step):
                r = rows[s:s + step]
                args = [torch.from_numpy(lh[s:s + step])] + [
                    torch.from_numpy(a[r]) for a in (b.x, b.z, b.xstar, b.mask)
                ] + [torch.from_numpy(prior_cells[b.cell_index[r]].astype(np.float32))]
                ref = fused_gp.gp_predict_plain(*[a.double().cuda() for a in args], jitter=1e-6)
                if not bool(ref.ok.all()):
                    _fail(f"N={b.capacity}: the float64 twin failed to factor a cell")
                sl = slice(s, s + len(r))
                dm = max(dm, float(np.max(np.abs(fs[gi[sl], gj[sl]] - ref.mean.cpu().numpy()))))
                ds_ = max(ds_, float(np.max(np.abs(es[gi[sl], gj[sl]] - ref.std.cpu().numpy()))))
            if not (dm <= 1e-4 and ds_ <= 1e-4):
                _fail(f"N={b.capacity}: |d mean| {dm}, |d std| {ds_} vs the float64 twin > 1e-4 m")
            check[b.capacity] = (len(rows), dm, ds_)
        return check


def phase_slice(tmp: str, day: _Day) -> dict:
    g = day.active.shape[0]
    hyp = os.path.join(tmp, "hypers.npz")
    values = dict(ell_x=2e5, ell_y=2e5, ell_t=2.0, sf2=0.03, sn2=0.005)
    np.savez(hyp, **{k: np.full((g, g), v) for k, v in values.items()})
    torch.cuda.reset_peak_memory_stats()
    res, date, launches, _, day_s, handler = _run_daily(tmp, ["--hypers", hyp])
    day.check_finite(res, date, ("interp", "interp_error", "lZ", "interp_smth",
                                 "interp_error_smth"))
    if launches["K1"] == 0 or launches["K2"] == 0:
        _fail(f"the slice did not launch both kernels: {launches}")
    check = day.check_predict(res, date, "_smth")
    buckets = []
    for n, cells, tile, wall in handler.buckets:
        buckets.append({"n": n, "cells": cells, "tile": tile, "wall_s": wall,
                        "cells_per_s": cells / wall, "checked": check[n][0],
                        "d_mean_vs_f64": check[n][1], "d_std_vs_f64": check[n][2]})
    predict_s = sum(b["wall_s"] for b in buckets)
    n_active = int(day.active.sum())
    _phase("slice", date=date, grid=g, active_cells=n_active, day_wall_s=day_s,
           predict_wall_s=predict_s, cells_per_s_predict=n_active / predict_s,
           cells_per_s_day=n_active / day_s,
           rmse_vs_truth_m=day.rmse(res[f"{date}_interp_smth"]),
           launches=launches, buckets=buckets,
           peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return {**launches, "result": res, "hypers_npz": hyp}


def _check_optimum(day: _Day, res, date, fit_batches=None) -> dict:
    """For 64 cells of each bucket, on the problem the pipeline fitted (the
    shuffled 1,024-point prefix; ``fit_batches``, where given, are the
    day's buckets shuffled as the fit shuffled them, else ``day``'s buckets
    are shuffled here as a day alone shuffles them), everything evaluated by
    the float64 twin:

    * ``gap``: the NLL at the hypers the fit wrote, minus the NLL a float64
      fit of the plain objective reaches from there under the same stopping
      rule. The starts of the pipeline's fine pass (nearest seed, then the
      cascade) are not kept, so the float64 fit starts from the fitted
      hypers themselves: the gap says what float64 L-BFGS still finds to
      gain there, whichever basin the start led to.
    * ``k3_vs_twin32``: from the same cold start (the reference x0), the
      float32 fit through K3 against the float32 fit through the plain
      autograd objective: NLL at K3's end minus NLL at the twin's end. Both
      are limited by float32 in the same way, so this isolates the kernel.
    * ``vs_cold_f64``: the NLL at the fitted hypers minus what a float64 fit
      reaches from the cold x0 (up to 16 cells), to show the basin.

    Gates, fixed before the final run. A float32 L-BFGS cannot be held to
    0.05 nats in every cell: the float32 NLL of ~1,000 points carries ~1e-3
    nats of rounding noise, the size of the plateau tolerance, so in a few
    percent of the cells a line search fails on noise, or the plateau rule
    fires on it, up to some nats short of the float64 optimum, through the
    plain float32 twin as through K3. So: (1) ``k3_vs_twin32`` at its 95th
    percentile <= 0.05 nats: K3 drives the optimizer as far as the plain
    float32 objective does; (2) the median ``gap`` <= 0.05 nats: the typical
    cell sits at a float64 optimum; (3) the mean ``gap`` <= 0.7 nats, the
    mean exact-NLL cost at which the JAX package accepted its default
    (Nystrom) objective (``optimizer.py:86-92``), so the cells that stop
    early cost the product no more than the reference's own choice does.
    """
    from optimalinterpolation_tpu_torch.models import exact_gp
    from optimalinterpolation_tpu_torch.models.optimizer import (
        OptimizeConfig,
        optimize_mll_chunked,
    )
    from optimalinterpolation_tpu_torch.ops import fused_gp
    from optimalinterpolation_tpu_torch.pipeline.daily import _permute_valid_points

    kw = dict(max_iters=60, ftol_abs=1e-3, jitter=1e-6)
    f64_cfg = OptimizeConfig(backend="xla", **kw)
    x0 = exact_gp.HYPER_INIT_LOG(RES_KM * 1e3, dtype=torch.float64, device="cuda")

    def stats(t):
        return {"max": t.max().item(), "median": t.median().item(), "mean": t.mean().item(),
                "p95": t.quantile(0.95).item(),
                "share_above_0.05": (t > 0.05).double().mean().item()}

    out = {}
    for b in fit_batches or day.batches:
        cap = min(b.capacity, day.cfg.opt_n_max)
        if cap < b.capacity and fit_batches is None:
            _permute_valid_points(b)  # the subsample the pipeline took
        rows, gi, gj = day.rows(b)
        lh = np.log(np.stack([res[f"{date}_{k}"][gi, gj] for k in HYPERS], 1))
        h, x, z, m = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                      for a in (lh, b.x[rows, :cap], b.z[rows, :cap], b.mask[rows, :cap]))
        data32 = (x, z - PRIOR, m)
        data64 = tuple(a.double() for a in data32)

        def nll64(hh):
            return fused_gp.gp_nll_plain(hh.double(), *data64, jitter=1e-6)

        at_fit = nll64(h)
        if not torch.isfinite(at_fit).all():
            _fail(f"N={b.capacity}: the float64 NLL at the fitted hypers is not finite")
        polished = optimize_mll_chunked(h, *data64, f64_cfg, chunk_rows=64)
        cold32 = x0.float().expand(len(rows), 5).contiguous()
        k3_fit = optimize_mll_chunked(cold32, *data32, OptimizeConfig(**kw), chunk_rows=64)
        twin_fit = optimize_mll_chunked(cold32, *data32, OptimizeConfig(backend="xla", **kw),
                                        chunk_rows=64)
        nc = min(16, len(rows))  # the cold float64 fit takes a cell through ~50 iterations
        cold64 = optimize_mll_chunked(x0.expand(nc, 5).contiguous(),
                                      *(a[:nc] for a in data64), f64_cfg, chunk_rows=64)
        out[b.capacity] = {
            "cells": len(rows), "n_opt": cap, "gap": stats(at_fit - polished.nll),
            "polish_iters_max": int(polished.iters.max()),
            "k3_vs_twin32": stats(nll64(k3_fit.log_hypers) - nll64(twin_fit.log_hypers)),
            "k3_iters_sum": int(k3_fit.iters.sum()), "twin32_iters_sum": int(twin_fit.iters.sum()),
            "k3_converged": int(k3_fit.converged.sum()),
            "twin32_converged": int(twin_fit.converged.sum()),
            "vs_cold_f64": stats(at_fit[:nc] - cold64.nll),
        }
    return out


def _rows_histogram(rows=None) -> dict:
    """K3 value launches by rows per launch, in bins: of ``rows`` (a
    Counter, rows -> launches), else of the last daily run."""
    from optimalinterpolation_tpu_torch.ops import fused_gp

    bins = [(1, 1), (2, 8), (9, 32), (33, 128), (129, 512), (513, 1 << 30)]
    rows = fused_gp.gp_nll.rows if rows is None else rows
    hist = {f"{lo}-{hi}" if hi < 1 << 30 else f">{lo - 1}":
            sum(c for r, c in rows.items() if lo <= r <= hi) for lo, hi in bins}
    hist["launches"] = sum(rows.values())
    hist["rows"] = sum(r * c for r, c in rows.items())
    return hist


def _stage_entries(records) -> list:
    """The stage INFO records as printed: converged cells as a share, and
    iterations a cell, in the fitting stages."""
    stages = []
    for e in records:
        e = dict(e)
        if "converged" in e:
            e["converged_share"] = e.pop("converged") / e["cells"]
            e["iters_a_cell"] = e["iters_sum"] / e["cells"]
        stages.append(e)
    return stages


# The fit phase's day as an earlier run gave it (PERF.md section 5: NVIDIA
# H100 80GB HBM3, 700.00 W). The buckets the day fits and predicts are the
# same arrays whichever gather builds them, so launches and rmse hold to the
# bit.
EARLIER_FIT = {"launches": {"K1": 1600, "K2": 8, "K3 value": 5133, "K3 grad": 672},
               "rmse_vs_truth_m": 0.011036935579973184}


def phase_fit(tmp: str, day: _Day) -> dict:
    torch.cuda.reset_peak_memory_stats()
    res, date, launches, syncs, day_s, handler = _run_daily(tmp, [])
    peak = torch.cuda.max_memory_allocated() / 1e9
    stages = _stage_entries(handler.stages)
    fitted = [e for e in stages if e["stage"] == "opt"]
    n_active = int(day.active.sum())
    fit_s, predict_s = _fit_predict_walls(stages)
    _phase("fit", date=date, active_cells=n_active, cut="none: the whole day",
           day_wall_s=day_s, cells_per_s_day=n_active / day_s,
           fit_wall_s=fit_s, predict_wall_s=predict_s,
           converged_share=sum(e["converged_share"] * e["cells"] for e in fitted)
           / sum(e["cells"] for e in fitted),
           host_syncs=syncs, launches=launches,
           rmse_vs_truth_m=day.rmse(res[f"{date}_interp_smth"]),
           rmse_pass1_vs_truth_m=day.rmse(res[f"{date}_interp"]),
           peak_mem_gb=peak, stages=stages, k3_value_rows=_rows_histogram())
    day.check_finite(res, date, [k[len(date) + 1:] for k in res])
    if min(launches.values()) == 0:
        _fail(f"the two-pass day did not launch every kernel: {launches}")
    rmse = day.rmse(res[f"{date}_interp_smth"])
    if launches != EARLIER_FIT["launches"] or rmse != EARLIER_FIT["rmse_vs_truth_m"]:
        _fail(f"the day moved off the earlier run's: launches {launches}, rmse {rmse!r} "
              f"(earlier {EARLIER_FIT})")
    check = day.check_predict(res, date, "_smth")
    optimum = _check_optimum(day, res, date)
    _phase("fit_check",
           pass2_vs_f64={str(n): {"cells": c, "d_mean": dm, "d_std": ds_}
                         for n, (c, dm, ds_) in check.items()},
           optimum_vs_f64={str(n): v for n, v in optimum.items()})
    _gate_optimum(optimum, date)
    return {**launches, "day_wall_s": day_s, "cells": n_active,
            "k3_value_launches": launches["K3 value"], "rmse_vs_truth_m": rmse,
            "fit_wall_s": fit_s, "predict_wall_s": predict_s, "host_syncs": syncs,
            "peak_mem_gb": peak, "stages": stages, "result": res}


def _fit_predict_walls(stages) -> tuple:
    """The fit wall (seed pass, cascade and fine stages) and the predict
    wall (pass 1 and pass 2) of a day's stage entries."""
    return (sum(e["wall_s"] for e in stages if "opt" in e["stage"] or "cascade" in e["stage"]),
            sum(e["wall_s"] for e in stages if e["stage"] in ("predict", "pass2")))


def _gate_optimum(optimum: dict, date: str) -> None:
    """The optimum gates of ``_check_optimum``'s docstring."""
    for n, v in optimum.items():
        if not v["k3_vs_twin32"]["p95"] <= NLL_TYPICAL:
            _fail(f"{date} N={n}: from the same start the fit through K3 ends "
                  f"{v['k3_vs_twin32']['p95']} nats (p95) above the float32 twin's")
        if not (v["gap"]["median"] <= NLL_TYPICAL and v["gap"]["mean"] <= NLL_MEAN):
            _fail(f"{date} N={n}: the float64 NLL at the fitted hypers is "
                  f"{v['gap']['median']} (median) / {v['gap']['mean']} (mean) nats above what "
                  f"a float64 fit reaches from there (> {NLL_TYPICAL} / {NLL_MEAN})")


# ---------------------------------------------------------------------------
# objectives: K3, the blocked objective and Nystrom M = 512 on the day's cells
# ---------------------------------------------------------------------------

NYS_M = 512
# the three objectives as optimizer._resolve_backend names them
OBJECTIVES = ("fused", "blocked", f"nystroem:{NYS_M}")
JITTER = 1e-6
# Routing rule (models/optimizer.py::_resolve_backend): Nystrom's quality is held when its
# fit's rmse vs the truth is within 0.5 mm of the exact fit's and its mean
# float64 exact-NLL cost is <= NLL_MEAN; a tie (within 10%) goes to the
# exact objective.
RMSE_HELD_M = 5e-4
TIE = 0.10


def _objective_flops(backend: str, n: int, rows: int, with_grad: bool) -> float:
    """Floating-point operations of one evaluation of ``rows`` cells,
    counted from the code (a multiply-add is two). The exact objectives:
    the Cholesky, N^3 / 3; with the gradient also L^-1 and the lower
    triangle of L^-T L^-1, N^3 in all (K3's count). The Nystrom objective:
    Phi = Knm Wm^T and Phi^T Phi, 2 N M^2 each, and two factor + inverse of
    an (M, M) matrix, 2 M^3 / 3 each; its backward pass three more N M^2
    products (6 N M^2) and the two chol_inv pullbacks, 10 M^3 each."""
    if backend.startswith("nystroem"):
        f = 4.0 * n * NYS_M ** 2 + 4.0 * NYS_M ** 3 / 3
        if with_grad:
            f += 6.0 * n * NYS_M ** 2 + 20.0 * NYS_M ** 3
    else:
        f = float(n) ** 3 if with_grad else float(n) ** 3 / 3
    return rows * f


def _objective_data(day, n: int, rows: int):
    """The first ``rows`` real cells of the day's bucket of capacity ``n``,
    valid points shuffled as the pipeline shuffles them (the Nystrom
    landmarks are the first M slots), on the card: (h, x, y, mask, rows,
    the bucket copy). Hypers: the slice's constants."""
    import copy

    from optimalinterpolation_tpu_torch.pipeline.daily import _permute_valid_points

    b = copy.deepcopy(next(bb for bb in day.batches if bb.capacity == n))
    _permute_valid_points(b)
    idx = np.nonzero(b.cell_index >= 0)[0][:rows]
    x, z, m = (torch.from_numpy(np.ascontiguousarray(a[idx])).cuda() for a in (b.x, b.z, b.mask))
    h = torch.log(torch.tensor([2e5, 2e5, 2.0, 0.03, 0.005], device="cuda")).expand(
        len(idx), 5).contiguous()
    return h, x, z - PRIOR, m, idx, b


def _fns(backend: str, x, y, m):
    from optimalinterpolation_tpu_torch.models import optimizer
    from optimalinterpolation_tpu_torch.ops.kernels import Kernel

    return optimizer._batched_fns(Kernel.MATERN32, JITTER, backend, x, y, m)


def _k_launches() -> tuple:
    from optimalinterpolation_tpu_torch.ops import blocked_gp, fused_gp

    return (blocked_gp._factor_invert.launches, fused_gp.gp_nll.launches,
            fused_gp.gp_nll_and_grad.launches)


def _objective_times(data: dict) -> list:
    """CUDA-event times of the value and the value + gradient of each
    objective: N = 1024 on 132, 8 and 1 rows, and the blocked and Nystrom
    objectives at N = 2048 and 4096 on 16 rows; beside each its bound
    (operations at the float32 peak, or bytes) and the K1 / K3 launches one
    evaluation makes."""
    cases = [(b, 1024, r) for b in OBJECTIVES for r in (132, 8, 1)]
    cases += [(b, n, 16) for n in (2048, 4096) for b in OBJECTIVES[1:]]
    out = []
    for backend, n, rows in cases:
        h, x, y, m = (a[:rows].contiguous() for a in data[n][:4])
        value_fn, vg_fn, _ = _fns(backend, x, y, m)
        k0 = _k_launches()
        value_fn(h)
        k1 = _k_launches()
        vg_fn(h)
        k2 = _k_launches()
        reps = 3 if rows * n ** 2 > 64 * 1024 ** 2 else 10
        line = {"backend": backend, "n": n, "rows": rows,
                "value_ms": _ms(lambda: value_fn(h), reps), "ms": _ms(lambda: vg_fn(h), reps),
                "k1_launches_value": k1[0] - k0[0], "k1_launches_grad": k2[0] - k1[0],
                "k3_launches": (k1[1] - k0[1]) + (k2[2] - k1[2])}
        in_bytes = rows * (5 * n + 11) * 4
        line["value_bound"] = _bound(in_bytes, _objective_flops(backend, n, rows, False))
        line["bound"] = _bound(in_bytes, _objective_flops(backend, n, rows, True))
        out.append(line)
    return out


def _objective_accuracy(data: dict) -> dict:
    """The new objectives in float32 on the card against the same port
    functions in float64 on the CPU, 8 rows at N = 1024: value within 1e-5
    relative, gradient within 1e-3 relative in norm (per row). Then: is a
    row's value the same bits in a 1-row and in the 132-row evaluation?
    Recorded; a deviation above 1e-6 relative fails."""
    out = {}
    h, x, y, m = data[1024][:4]
    for backend in OBJECTIVES[1:]:
        sub = [a[:8].contiguous() for a in (h, x, y, m)]
        v32, g32 = _fns(backend, *sub[1:])[1](sub[0])
        v64, g64 = _fns(backend, *(a.cpu().double() for a in sub[1:]))[1](sub[0].cpu().double())
        dv = ((v32.cpu().double() - v64).abs() / v64.abs()).max().item()
        dg = (torch.linalg.vector_norm(g32.cpu().double() - g64, dim=1)
              / torch.linalg.vector_norm(g64, dim=1)).max().item()
        if not (torch.isfinite(v64).all() and dv <= 1e-5 and dg <= 1e-3):
            _fail(f"{backend} on the card vs float64: value {dv} (<= 1e-5), gradient {dg} "
                  "(<= 1e-3 relative in norm)")
        wave = _fns(backend, x, y, m)[0](h)
        one = _fns(backend, *(a[:1].contiguous() for a in (x, y, m)))[0](h[:1].contiguous())
        rel = ((one[0] - wave[0]).abs() / wave[0].abs()).item()
        if not rel <= 1e-6:
            _fail(f"{backend}: a row's value in a 1-row evaluation is {rel} relative off the "
                  "132-row evaluation's")
        out[backend] = {"d_value_rel": dv, "d_grad_rel_norm": dg,
                        "one_row_bit_equal_to_wave": bool(torch.equal(one[0], wave[0])),
                        "one_row_vs_wave_rel": rel}
    return out


def _objective_memory(data: dict) -> dict:
    """Peak device bytes a row of one evaluation holds, 16 rows, against
    the pipeline's chunk models (pipeline/daily.py): the blocked objective
    in (N, N) buffers, with the line search's carried factors alive while
    the next trial factors and the gradient from them; the Nystrom objective
    with its gradient at two N, solved for (N, M) and (M, M) buffers."""
    from optimalinterpolation_tpu_torch.pipeline import daily

    def peak_per_row(backend, n):
        h, x, y, m = (a[:16].contiguous() for a in data[n][:4])
        value_fn, vg_fn, pair = _fns(backend, x, y, m)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if pair is None:
            vg_fn(h)
        else:
            _, carried = pair[0](h)
            pair[0](h + 0.01)
            pair[1](h, carried)
            del carried
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 16 / 4  # floats a row

    def nystroem_floats(n, nm, mm):
        return nm * n * NYS_M + mm * NYS_M ** 2

    out = {f"blocked_n{n}_nn_buffers": peak_per_row("blocked", n) / n ** 2 for n in (1024, 2048)}
    p1, p4 = (peak_per_row(OBJECTIVES[2], n) for n in (1024, 4096))
    nm = (p4 - p1) / (NYS_M * (4096 - 1024))
    mm = (p1 - nystroem_floats(1024, nm, 0)) / NYS_M ** 2
    model = (daily._BLOCKED_OBJECTIVE_BUFFERS, daily._NYSTROEM_NM_BUFFERS,
             daily._NYSTROEM_MM_BUFFERS)
    out.update(nystroem_nm_buffers=nm, nystroem_mm_buffers=mm,
               model=dict(zip(("blocked", "nystroem_nm", "nystroem_mm"), model)))
    out["model_ok"] = bool(
        max(out["blocked_n1024_nn_buffers"], out["blocked_n2048_nn_buffers"]) <= model[0]
        and all(nystroem_floats(n, nm, mm) <= nystroem_floats(n, *model[1:])
                for n in (1024, 4096)))
    return out


class _EvalCount:
    """Counts the objective evaluations of optimizer runs, by kind, in calls
    and rows, through a wrapper around ``optimizer._batched_fns``."""

    def __init__(self):
        from optimalinterpolation_tpu_torch.models import optimizer

        self.optimizer = optimizer
        self.orig = optimizer._batched_fns
        self.calls, self.rows = {}, {}

    def _wrap(self, kind, fn):
        def counted(h, *args, **kw):
            self.calls[kind] = self.calls.get(kind, 0) + 1
            self.rows[kind] = self.rows.get(kind, 0) + int(h.shape[0])
            return fn(h, *args, **kw)
        return counted

    def __enter__(self):
        def fns(*args):
            value_fn, vg_fn, pair = self.orig(*args)
            if pair is not None:
                pair = (self._wrap("value", pair[0]), self._wrap("grad_from_factors", pair[1]))
            return self._wrap("value", value_fn), self._wrap("value_and_grad", vg_fn), pair
        self.optimizer._batched_fns = fns
        return self

    def __exit__(self, *exc):
        self.optimizer._batched_fns = self.orig


def _objective_ab(day) -> dict:
    """The fine stage at N = 1024 under each objective: 1,024 cells of the
    day's 1024 bucket, from one shared warm start (a cold K3 cascade stage
    on the 512-point prefix, as the pipeline's), at the day's fine-stage
    settings. For each: wall, iterations, evaluations by kind, K1 / K3
    launches, converged share, peak memory; against the K3 fit, the float64
    exact-NLL cost and the exact (float64) predictions' |d mean| and
    |d std|; rmse of the predictions vs the truth."""
    from optimalinterpolation_tpu_torch.models import exact_gp
    from optimalinterpolation_tpu_torch.models.optimizer import (
        OptimizeConfig,
        _seg_schedule,
        optimize_mll_chunked,
    )
    from optimalinterpolation_tpu_torch.ops import fused_gp
    from optimalinterpolation_tpu_torch.pipeline.daily import DailyConfig, _chunk_rows

    _, x, y, m, idx, b = _objective_data(day, 1024, 1024)
    cells = len(idx)
    cfg = DailyConfig()
    x0 = exact_gp.HYPER_INIT_LOG(RES_KM * 1e3, device="cuda").expand(cells, 5).contiguous()
    t0 = time.perf_counter()
    warm = optimize_mll_chunked(
        x0, *(a[:, :512].contiguous() for a in (x, y, m)),
        OptimizeConfig(backend="fused", ftol_abs=cfg.warmstart_ftol, jitter=JITTER),
        chunk_rows=_chunk_rows(512, cells, cfg, 4, "fused"), segment_iters=cfg.opt_segment_iters)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    x64, y64, m64 = (a.double() for a in (x, y, m))
    xs64 = torch.from_numpy(b.xstar[idx]).cuda().double()
    mean64 = torch.full((cells,), PRIOR, dtype=torch.float64, device="cuda")
    ci = b.cell_index[idx]
    truth = day.truth[day.active_ij[0][ci], day.active_ij[1][ci]]

    def exact64(h):
        """float64 exact NLL and posterior (mean, std), in chunks of 128."""
        nll, mean, std = [], [], []
        for s in range(0, cells, 128):
            sl = slice(s, s + 128)
            hh = h[sl].double()
            nll.append(fused_gp.gp_nll_plain(hh, x64[sl], y64[sl], m64[sl], jitter=JITTER))
            p = fused_gp.gp_predict_plain(hh, x64[sl], y64[sl] + PRIOR, xs64[sl], m64[sl],
                                          mean64[sl], jitter=JITTER)
            mean.append(p.mean)
            std.append(p.std)
        return torch.cat(nll), torch.cat(mean), torch.cat(std)

    fits = {}
    for backend in ("fused", "blocked", "nystroem"):
        ocfg = OptimizeConfig(backend=backend, nystroem_m=NYS_M, ftol_abs=1e-3, jitter=JITTER)
        resolved = OBJECTIVES[("fused", "blocked", "nystroem").index(backend)]
        chunk = _chunk_rows(1024, cells, cfg, 4, resolved)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k0 = _k_launches()
        with _EvalCount() as count:
            t0 = time.perf_counter()
            res = optimize_mll_chunked(warm.log_hypers, x, y, m, ocfg, chunk_rows=chunk,
                                       segment_iters=cfg.opt_segment_iters,
                                       lead_schedule=(0,) + _seg_schedule())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        k1 = _k_launches()
        nll, mean, std = exact64(res.log_hypers)
        fits[backend] = {
            "backend": resolved, "wall_s": wall, "chunk_rows": chunk,
            "iters_sum": int(res.iters.sum()), "evaluation_calls": count.calls,
            "evaluation_rows": count.rows, "k1_launches": k1[0] - k0[0],
            "k3_launches": {"value": k1[1] - k0[1], "grad": k1[2] - k0[2]},
            "converged_share": res.converged.double().mean().item(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "rmse_vs_truth_m": float(np.sqrt(np.mean((mean.cpu().numpy() - truth) ** 2))),
            "_nll": nll, "_mean": mean, "_std": std,
        }
        if not (torch.isfinite(nll).all() and torch.isfinite(mean).all()):
            _fail(f"the {backend} fit left cells whose exact NLL or prediction is not finite")
    ref = fits["fused"]
    for f in fits.values():
        cost = f["_nll"] - ref["_nll"]
        dm = (f["_mean"] - ref["_mean"]).abs()
        ds_ = (f["_std"] - ref["_std"]).abs()
        f.update(nll_cost_vs_k3={"mean": cost.mean().item(), "median": cost.median().item(),
                                 "p99": cost.quantile(0.99).item()},
                 d_mean_vs_k3={"max": dm.max().item(), "p99": dm.quantile(0.99).item()},
                 d_std_vs_k3={"max": ds_.max().item(), "p99": ds_.quantile(0.99).item()})
    for f in fits.values():
        for k in ("_nll", "_mean", "_std"):
            del f[k]
    return {"cells": cells, "warm_start_s": warm_s, "warm_iters_sum": int(warm.iters.sum()),
            "fits": fits}


def _routing_rule(times: list, ab: dict) -> dict:
    """``"auto"``'s thresholds by the rule (PERF.md, routing): the fit time
    a cell at N = 1024 is the A/B's wall per cell; at N = 2048 and 4096 it
    is estimated from the evaluations a cell of the A/B made, by kind, times
    the per-row evaluation times at that N (a gradient from carried factors
    costs the value + gradient time less the value time). Nystrom takes the
    smallest N at which it is faster than the exact objective ``"auto"``
    would use there by more than the tie margin, with its quality held;
    the blocked objective takes the N from which it beats K3 on value +
    gradient at 132 rows, else it stays above K3's range (2049)."""
    per_row = {(t["backend"], t["n"]): (t["value_ms"] / t["rows"], t["ms"] / t["rows"])
               for t in times if t["rows"] in (132, 16)}
    cells = ab["cells"]

    def fit_ms(backend, n):
        f = ab["fits"][backend.split(":")[0]]
        if n == 1024:
            return f["wall_s"] * 1e3 / cells
        v, vg = per_row[(backend, n)]
        rows = f["evaluation_rows"]
        return (rows.get("value", 0) * v + rows.get("value_and_grad", 0) * vg
                + rows.get("grad_from_factors", 0) * (vg - v)) / cells

    k3 = ab["fits"]["fused"]
    nys = ab["fits"]["nystroem"]
    held = (nys["rmse_vs_truth_m"] - k3["rmse_vs_truth_m"] <= RMSE_HELD_M
            and nys["nll_cost_vs_k3"]["mean"] <= NLL_MEAN)
    v_k3, v_blk = per_row[("fused", 1024)][1], per_row[("blocked", 1024)][1]
    blocked_min_n = 1024 if v_blk < (1 - TIE) * v_k3 else 2049
    est, nystroem_min_n = {}, 0
    for n in (1024, 2048, 4096):
        exact = "fused" if n <= 1024 and n < blocked_min_n else "blocked"
        est[n] = {"exact": exact, "exact_ms_per_cell": fit_ms(exact, n),
                  "nystroem_ms_per_cell": fit_ms(OBJECTIVES[2], n)}
        if held and not nystroem_min_n and \
                est[n]["nystroem_ms_per_cell"] < (1 - TIE) * est[n]["exact_ms_per_cell"]:
            nystroem_min_n = n
    from optimalinterpolation_tpu_torch.models import optimizer

    defaults = {"nystroem_min_n": optimizer.OptimizeConfig().nystroem_min_n,
                "blocked_min_n": optimizer.blocked_min_n()}
    chosen = {"nystroem_min_n": nystroem_min_n, "blocked_min_n": blocked_min_n}
    return {"nystroem_quality_held": held, "fit_ms_per_cell": {str(n): v for n, v in est.items()},
            "rule": chosen, "defaults": defaults, "defaults_follow_rule": chosen == defaults}


def phase_objectives(day) -> dict:
    """The three objectives on the day's cells: times, accuracy, memory,
    the fine-stage A/B and the routing rule's thresholds. Returns K1's
    launches on the two new objectives' A/B fits."""
    data = {n: _objective_data(day, n, 132 if n == 1024 else 16) for n in (1024, 2048, 4096)}
    times = _objective_times(data)
    for t in times:
        _phase("objective_times", **t)
    accuracy = _objective_accuracy(data)
    memory = _objective_memory(data)
    ab = _objective_ab(day)
    rule = _routing_rule(times, ab)
    _phase("objectives", accuracy=accuracy, memory=memory, ab=ab, routing=rule)
    if not memory["model_ok"]:
        _fail(f"an objective holds more device memory a row than the pipeline's chunk "
              f"model: {memory}")
    for backend in ("blocked", "nystroem"):
        f = ab["fits"][backend]
        if f["k1_launches"] == 0 or sum(f["k3_launches"].values()) != 0:
            _fail(f"the {backend} fit did not run on K1 alone: K1 {f['k1_launches']}, "
                  f"K3 {f['k3_launches']}")
    return {"blocked objective": ab["fits"]["blocked"]["k1_launches"],
            "nystroem chol_inv": ab["fits"]["nystroem"]["k1_launches"]}


# ---------------------------------------------------------------------------
# season: strided waves of days through pipeline.season.run_season
# ---------------------------------------------------------------------------

SEASON_DAYS = 12  # 4 valid 9-day windows
SEASON_WINDOWS = [0, 1, 2, 3]
DAY_PARALLEL = 2
# The single day of the fit phase as an earlier run measured it (PERF.md
# section 5: NVIDIA H100 80GB HBM3, 700.00 W), printed beside the waves.
EARLIER_DAY = {"label": "earlier run, PERF.md section 5", "cells_per_s": 399.5,
               "k3_value_launches": 5133, "cells": 19989}
# Host steps outside the stages, by the functions the pipeline calls for
# them, in the modules that call them.
HOST_STEPS = {
    "gather": [("pipeline.multiday", "gather_neighborhoods")],
    "window": [("pipeline.multiday", "flatten_window")],
    "nearest_fill": [("pipeline.multiday", "nearest_fill"), ("pipeline.daily", "nearest_fill")],
    "pickle": [("pipeline.season", "save_pickle")],
    "netcdf": [("pipeline.season", "write_result_quicklook")],
}


class _SeasonProbe:
    """Wraps the season's host steps (``HOST_STEPS``) to time them on the
    host clock, and ``season.interpolate_days`` to read, for each wave, the
    launch counts, K3 value launches by rows, host synchronisations, stage
    records and peak device memory before and after it."""

    def __init__(self, handler):
        import importlib

        self.handler = handler
        self.spans = []  # (step, start, end)
        self.waves = []
        self.patched = []
        for step, places in HOST_STEPS.items():
            for mod_name, attr in places:
                mod = importlib.import_module(f"optimalinterpolation_tpu_torch.{mod_name}")
                self.patched.append((mod, attr, getattr(mod, attr)))
                setattr(mod, attr, self._timed(step, getattr(mod, attr)))
        from optimalinterpolation_tpu_torch.pipeline import season

        self.patched.append((season, "interpolate_days", season.interpolate_days))
        season.interpolate_days = self._wave(season.interpolate_days)

    def _timed(self, step, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.spans.append((step, t0, time.perf_counter()))
            return out
        return timed

    def _wave(self, fn):
        from optimalinterpolation_tpu_torch.models import optimizer
        from optimalinterpolation_tpu_torch.ops import fused_gp

        def wave(ds, days, *args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            launches0 = _counts()
            rows0 = fused_gp.gp_nll.rows.copy()
            syncs0 = optimizer._lbfgs_segment.host_syncs
            n_stages = len(self.handler.stages)
            t0 = time.perf_counter()
            out = fn(ds, days, *args, **kw)
            torch.cuda.synchronize()
            self.waves.append({
                "windows": list(days), "t0": t0, "call_s": time.perf_counter() - t0,
                "launches": {k: v - launches0[k] for k, v in _counts().items()},
                "rows": fused_gp.gp_nll.rows - rows0,
                "host_syncs": optimizer._lbfgs_segment.host_syncs - syncs0,
                "stages": _stage_entries(self.handler.stages[n_stages:]),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "cells": sum(int(np.isfinite(r.interp).sum()) for r in out),
            })
            return out
        return wave

    def close(self):
        for mod, attr, fn in self.patched:
            setattr(mod, attr, fn)

    def report(self, j: int) -> dict:
        """Wave ``j``: the wall from its first gather to its last output file
        and the host seconds of each step outside the stages."""
        w = dict(self.waves[j])
        t_next = self.waves[j + 1]["t0"] if j + 1 < len(self.waves) else float("inf")
        spans = [sp for sp in self.spans if w["t0"] <= sp[1] < t_next]
        wall = max(sp[2] for sp in spans) - min(sp[1] for sp in spans if sp[0] == "gather")
        host = {step: sum(e - b for st, b, e in spans if st == step) for step in HOST_STEPS}
        stage_s = sum(e["wall_s"] for e in w["stages"])
        host["other"] = wall - stage_s - sum(host.values())
        return {"windows": w.pop("windows"), "cells": w["cells"], "wall_s": wall,
                "cells_per_s": w["cells"] / wall, "interpolate_days_s": w["call_s"],
                "cells_per_s_interpolate_days": w["cells"] / w["call_s"],
                "stage_s": stage_s, "host_outside_stages_s": host,
                "launches": w["launches"], "k3_value_rows": _rows_histogram(w["rows"]),
                "k3_value_launches_a_cell": w["launches"]["K3 value"] / w["cells"],
                "host_syncs": w["host_syncs"], "peak_mem_gb": w["peak_mem_gb"],
                "stages": w["stages"]}


def _counts() -> dict:
    from optimalinterpolation_tpu_torch.ops import blocked_gp, fused_gp

    return {"K1": blocked_gp._factor_invert.launches, "K2": fused_gp.gp_predict.launches,
            "K3 value": fused_gp.gp_nll.launches, "K3 grad": fused_gp.gp_nll_and_grad.launches}


def _wrappers() -> tuple:
    """The kernels' wrappers, in the order of ``_counts``."""
    from optimalinterpolation_tpu_torch.ops import blocked_gp, fused_gp

    return (blocked_gp._factor_invert, fused_gp.gp_predict, fused_gp.gp_nll,
            fused_gp.gp_nll_and_grad)


def _zero_counts() -> None:
    from optimalinterpolation_tpu_torch.models import optimizer
    from optimalinterpolation_tpu_torch.ops import fused_gp

    for fn in _wrappers():
        fn.launches = 0
        fn.streams.clear()
    fused_gp.gp_nll.rows.clear()
    optimizer._lbfgs_segment.host_syncs = 0


def _wave_fit_batches(wave: list) -> list:
    """For each day of a wave (``_Day`` objects in wave order), its rows of
    the wave's combined buckets, shuffled as the fit shuffled them: one
    permutation per row over the combined bucket, where the fit took a
    subsample. Cell indices are the day's own."""
    from optimalinterpolation_tpu_torch.data.neighbors import NeighborhoodBatch
    from optimalinterpolation_tpu_torch.pipeline import multiday
    from optimalinterpolation_tpu_torch.pipeline.daily import _permute_valid_points

    cfg = wave[0].cfg
    offsets = multiday._offsets(wave)
    out = [[] for _ in wave]
    for cap, items in sorted(multiday._per_capacity(wave).items()):
        full_b, day_of_row = multiday._concat_buckets(items, offsets, cfg.batch_multiple)
        if min(cap, cfg.opt_n_max) < cap:
            _permute_valid_points(full_b)
        for dpos in range(len(wave)):
            r = (day_of_row == dpos) & (full_b.cell_index >= 0)
            out[dpos].append(NeighborhoodBatch(
                x=full_b.x[r], z=full_b.z[r], mask=full_b.mask[r], xstar=full_b.xstar[r],
                cell_index=full_b.cell_index[r] - offsets[dpos], n_valid_cells=int(r.sum())))
    return out


@contextlib.contextmanager
def _without_h5py():
    """``import h5py`` raises inside, as on a machine without h5py: the
    quicklook NetCDFs go through ``io/hdf5.py``."""
    had, prev = "h5py" in sys.modules, sys.modules.get("h5py")
    sys.modules["h5py"] = None
    try:
        yield
    finally:
        if had:
            sys.modules["h5py"] = prev
        else:
            del sys.modules["h5py"]


@contextlib.contextmanager
def _netcdf_writes(module):
    """Wraps ``module.write_result_quicklook``; yields {path: seconds of its
    write}."""
    write, seconds = module.write_result_quicklook, {}

    def timed(*args, **kw):
        t0 = time.perf_counter()
        path = write(*args, **kw)
        seconds[path] = time.perf_counter() - t0
        return path

    module.write_result_quicklook = timed
    try:
        yield seconds
    finally:
        module.write_result_quicklook = write


def _check_netcdf(path: str, res: dict, date: str, lonlat, write_s: dict) -> dict:
    """The quicklook NetCDF at ``path``, read back by ``read_quicklook``,
    against its pickle ``res``: ``radar_freeboard`` is ``interp_smth.T``,
    ``uncertainty`` ``interp_error_smth.T`` and ``lat`` / ``lon`` the grid's
    (``lonlat``) transposed, bit for bit with NaNs in place; the title
    starts with the date. Returns its bytes and its write (``write_s``) and
    read seconds."""
    from optimalinterpolation_tpu_torch.io.quicklook import read_quicklook

    t0 = time.perf_counter()
    q = read_quicklook(path)
    read_s = time.perf_counter() - t0
    name = os.path.basename(path)
    if q.date != date:
        _fail(f"{name}: the title starts with {q.date!r}, not {date}")
    lon, lat = lonlat
    for field, ref in (("radar_freeboard", res[f"{date}_interp_smth"]),
                       ("uncertainty", res[f"{date}_interp_error_smth"]),
                       ("lat", lat), ("lon", lon)):
        got, want = getattr(q, field), np.ascontiguousarray(ref.T, dtype=np.float64)
        if not (got.dtype == np.float64 and got.shape == want.shape
                and np.array_equal(got.view(np.uint64), want.view(np.uint64))):
            _fail(f"{name}: {field} is not the pickle's field transposed, bit for bit")
    return {"bytes": os.path.getsize(path), "write_s": write_s[path], "read_s": read_s}


def _run_season(ds, outdir: str):
    """``run_season`` over ``SEASON_WINDOWS`` at the fit settings of the
    ``daily`` and ``season`` commands' defaults, those of the fit phase's
    day: ``DailyConfig()`` with the commands' plateau stop (``--ftol``
    1e-3) and jitter (1e-6). ``DailyConfig()`` alone has no plateau stop,
    and every cell would run to the 60-iteration cap."""
    from optimalinterpolation_tpu_torch.models.optimizer import OptimizeConfig
    from optimalinterpolation_tpu_torch.pipeline.daily import DailyConfig
    from optimalinterpolation_tpu_torch.pipeline.season import SeasonConfig, run_season

    lines = []
    daily = DailyConfig(opt=OptimizeConfig(ftol_abs=1e-3), jitter=1e-6)
    cfg = SeasonConfig(daily=daily, outdir=outdir, day_parallel=DAY_PARALLEL)
    res = run_season(ds, cfg, days=SEASON_WINDOWS, prior_fn=lambda d: PRIOR, log=lines.append)
    torch.cuda.synchronize()
    return res, lines


def phase_season(fit: dict, tmp: str) -> dict:
    """The season phase (see the module docstring), on a season it writes in
    ``tmp`` with its pickles under ``tmp/season``. Returns each kernel's
    launches and the host gather seconds in the cold and the chained wave."""
    from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season
    from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season
    from optimalinterpolation_tpu_torch.io.pickles import load_pickle
    from optimalinterpolation_tpu_torch.io.quicklook import grid_lonlat
    from optimalinterpolation_tpu_torch.pipeline import season

    t0 = time.perf_counter()
    make_synthetic_season(tmp, grid_res_km=RES_KM, n_days=SEASON_DAYS, seed=7,
                          tracks_per_day=(10, 3, 8, 8), noise_std=0.1)
    make_s = time.perf_counter() - t0
    ds = read_freeboard_season(tmp, RES_KM, "2018-2019")
    out = os.path.join(tmp, "season")
    handler = _DailyLog()
    log = logging.getLogger("optimalinterpolation_tpu_torch.pipeline.daily")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    probe = _SeasonProbe(handler)
    try:
        _zero_counts()
        t0 = time.perf_counter()
        with _netcdf_writes(season) as write_s:
            results, lines = _run_season(ds, out)
        season_s = time.perf_counter() - t0
        launches = _counts()
        waves = [probe.report(j) for j in range(len(probe.waves))]
    finally:
        probe.close()
        log.removeHandler(handler)
    for w in waves:
        _phase("season_wave", **w)
    if [w["windows"] for w in waves] != [[0, 2], [1, 3]] or len(results) != 4:
        _fail(f"the season ran {[w['windows'] for w in waves]}, not windows [0, 2], [1, 3]")
    chained = [e["stage"] for e in waves[1]["stages"]]
    if any(st.startswith("seed:") or st == "cascade" for st in chained):
        _fail(f"the chained wave ran a seed pass or a cascade: {chained}")
    if min(launches.values()) == 0:
        _fail(f"the season did not launch every kernel: {launches}")

    days = {w: _Day(tmp, w) for w in SEASON_WINDOWS}
    fit_batches = {}
    for wave in ([0, 2], [1, 3]):
        for w, b in zip(wave, _wave_fit_batches([days[w] for w in wave])):
            fit_batches[w] = b
    checks = {}
    lonlat = grid_lonlat(ds.x, ds.y)
    for w, day in days.items():
        res = load_pickle(os.path.join(out, f"CS2S3_{day.date}_{RES_KM}km.pkl"))
        if len(res) != 15:
            _fail(f"{day.date}: the pickle has {len(res)} keys, not 15")
        day.check_finite(res, day.date, [k[len(day.date) + 1:] for k in res])
        netcdf = _check_netcdf(os.path.join(out, f"CS2S3_{day.date}_{RES_KM}km_quicklook.nc"),
                               res, day.date, lonlat, write_s)
        check = day.check_predict(res, day.date, "_smth")
        checks[day.date] = {
            "window": w, "active_cells": int(day.active.sum()),
            "rmse_vs_truth_m": day.rmse(res[f"{day.date}_interp_smth"]),
            "rmse_pass1_vs_truth_m": day.rmse(res[f"{day.date}_interp"]),
            "pass2_vs_f64": {str(n): {"cells": c, "d_mean": dm, "d_std": ds_}
                             for n, (c, dm, ds_) in check.items()},
            "netcdf": netcdf}
        t_opt = time.perf_counter()
        optimum = _check_optimum(day, res, day.date, fit_batches[w])
        checks[day.date]["optimum_vs_f64"] = {str(n): v for n, v in optimum.items()}
        checks[day.date]["optimum_check_s"] = time.perf_counter() - t_opt
        _gate_optimum(optimum, day.date)
    _phase("season_check", days=checks)

    # a second call on the same directory: every day resumed, nothing launched
    _zero_counts()
    again, again_lines = _run_season(ds, out)
    resumed = _counts()
    if again or any(resumed.values()) or sum("skipping (resume)" in s
                                             for s in again_lines) != 4:
        _fail(f"the second season call did not resume all four days: {len(again)} days "
              f"run, launches {resumed}, log {again_lines}")
    _phase("season", windows=SEASON_WINDOWS, day_parallel=DAY_PARALLEL,
           synthetic_season_s=make_s, season_call_s=season_s, log=lines,
           launches=launches, resume={"days_run": 0, "launches": resumed},
           waves={"cold": {k: waves[0][k] for k in ("cells", "wall_s", "cells_per_s",
                                                     "cells_per_s_interpolate_days",
                                                     "k3_value_launches_a_cell")},
                  "chained": {k: waves[1][k] for k in ("cells", "wall_s", "cells_per_s",
                                                        "cells_per_s_interpolate_days",
                                                        "k3_value_launches_a_cell")}},
           single_day_this_run={"cells_per_s": fit["cells"] / fit["day_wall_s"],
                                "k3_value_launches": fit["k3_value_launches"],
                                "k3_value_launches_a_cell":
                                    fit["k3_value_launches"] / fit["cells"]},
           single_day_earlier=EARLIER_DAY)
    return {"cold": waves[0]["launches"], "chained": waves[1]["launches"],
            "gather_s": {name: waves[j]["host_outside_stages_s"]["gather"]
                         for j, name in enumerate(("cold", "chained"))},
            "days": days}


# ---------------------------------------------------------------------------
# chain: bin, hypers, the quicklook day at seasonal hypers, validate
# ---------------------------------------------------------------------------

# The season phase's gather seconds a wave when the gather took SciPy's
# kd-tree and filled its buckets cell by cell (PERF.md section 5: NVIDIA H100
# 80GB HBM3, 700.00 W), printed beside this run's.
EARLIER_GATHER_S = {"cold": 12.46, "chained": 10.55}
BIN_DAYS, BIN_TRACKS, BIN_ROWS = 2, 10, 20_000
BIN_MONTH = "201811"  # the first month of the 2018-2019 season table


def _cli(argv: list) -> tuple:
    """``cli.main(argv)``: (its last JSON line, wall seconds)."""
    from optimalinterpolation_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1]), time.perf_counter() - t0


def _chain_gather(ds) -> list:
    """Windows 0-3 of the season: ``gather_neighborhoods`` (the native grid
    hash and array fill) against its plain version (the kd-tree lists
    filled cell by cell, as the JAX package's gather fills them), every
    array of every bucket equal; the seconds of each and of the two
    neighbour searches alone."""
    from optimalinterpolation_tpu_torch import native
    from optimalinterpolation_tpu_torch.data import neighbors
    from optimalinterpolation_tpu_torch.data.window import flatten_window
    from optimalinterpolation_tpu_torch.pipeline.daily import DailyConfig

    cfg = DailyConfig()
    kw = dict(t_star=float(cfg.t_mid), radius_m=cfg.radius_km * 1e3, buckets=cfg.buckets,
              batch_multiple=cfg.batch_multiple, dtype=np.float32)
    out = []
    for w in SEASON_WINDOWS:
        train = flatten_window(ds.obs[:, :, :, w:w + cfg.window_days], ds.x, ds.y)
        ij = np.nonzero(np.isfinite(ds.sie[:, :, w + cfg.t_mid]))
        cells = np.stack([ds.x[ij], ds.y[ij]], axis=1)
        secs = {}
        for name, fn in (("search_native_s", lambda: native.radius_neighbors(
                              train.xy, cells, kw["radius_m"])),
                         ("search_kdtree_s", lambda: neighbors._neighbor_lists_kdtree(
                              train, cells, kw["radius_m"])),
                         ("gather_s", lambda: neighbors.gather_neighborhoods(train, cells, **kw)),
                         ("gather_plain_s", lambda: neighbors._gather_plain(train, cells, **kw))):
            t0 = time.perf_counter()
            secs[name] = (fn(), time.perf_counter() - t0)
        got, ref = secs["gather_s"][0], secs["gather_plain_s"][0]
        if [b.capacity for b in got] != [b.capacity for b in ref]:
            _fail(f"window {w}: buckets {[b.capacity for b in got]} != the plain gather's")
        for g, r in zip(got, ref):
            for name in ("x", "z", "mask", "xstar", "cell_index", "n_valid_cells"):
                a, b = getattr(g, name), getattr(r, name)
                if not (np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype):
                    _fail(f"window {w} N={r.capacity}: {name} differs from the plain gather's")
        out.append({"window": w, "points": len(train), "cells": len(cells),
                    "neighbours_mean": float(np.diff(secs["search_native_s"][0][0]).mean()),
                    "buckets": {str(b.capacity): b.n_valid_cells for b in got},
                    **{k: v[1] for k, v in secs.items()}})
    return out


def _write_proc_files(raw: str) -> dict:
    """``.proc`` text from seed 7, as ``tests/test_data_plane.py::
    test_proc_flow`` writes it (8 columns, freeboard in column 4, the flag in
    column 7): BIN_DAYS days x BIN_TRACKS tracks x BIN_ROWS rows, a fifth of
    the flags invalid, freeboards drawn past both limits, 1% ``nan``
    tokens. Returns {date: [paths]}."""
    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(raw, BIN_MONTH))
    files = {}
    for day in range(1, BIN_DAYS + 1):
        date = f"{BIN_MONTH}{day:02d}"
        for track in range(BIN_TRACKS):
            cols = np.zeros((BIN_ROWS, 8))
            cols[:, 0] = rng.uniform(-180, 180, BIN_ROWS)
            cols[:, 1] = rng.uniform(62, 89, BIN_ROWS)
            cols[:, 2:4] = rng.normal(size=(BIN_ROWS, 2))
            cols[:, 4] = rng.uniform(-0.5, 0.8, BIN_ROWS)
            cols[:, 5:7] = rng.normal(size=(BIN_ROWS, 2))
            cols[:, 7] = rng.choice([1, 2], BIN_ROWS, p=[0.2, 0.8])
            cols[rng.random(BIN_ROWS) < 0.01, 4] = np.nan
            path = os.path.join(raw, BIN_MONTH, f"CS2_{track:02d}_{date}_v1.proc")
            np.savetxt(path, cols, fmt="%.9g")
            files.setdefault(date, []).append(path)
    return files


def _chain_bin(tmp: str) -> dict:
    """The ``bin`` command on seeded ``.proc`` files against the plain path
    (``np.genfromtxt``, the validity filter, the projection, ``bin_points``)."""
    from optimalinterpolation_tpu_torch import native
    from optimalinterpolation_tpu_torch.data.binner import FB_MAX, FB_MIN, VALID_FLAG, bin_points
    from optimalinterpolation_tpu_torch.data.projection import PolarStereo
    from optimalinterpolation_tpu_torch.io.pickles import load_pickle

    raw, binned = os.path.join(tmp, "raw"), os.path.join(tmp, "binned")
    t0 = time.perf_counter()
    files = _write_proc_files(raw)
    write_s = time.perf_counter() - t0
    line, bin_s = _cli(["bin", "--datapath", raw, "--outdir", binned, "--sat", "CS2_SAR",
                        "--grid-res", str(RES_KM)])
    if line != {"days_binned": BIN_DAYS}:
        _fail(f"bin: {line}")
    fields = load_pickle(os.path.join(binned, f"CS2_SAR_dailyFB_{RES_KM}km_2018-2019_season.pkl"))
    proj = PolarStereo.from_boundinglat(60.0, 0.0)
    checked = {}
    for date, paths in files.items():
        t0 = time.perf_counter()
        for path in paths:
            native.parse_proc(path)
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = np.concatenate([np.genfromtxt(path) for path in paths])
        genfromtxt_s = time.perf_counter() - t0
        fb = data[:, 4]
        keep = (data[:, 7] == VALID_FLAG) & (fb >= FB_MIN) & (fb <= FB_MAX) & np.isfinite(fb)
        x, y = proj.forward(data[keep, 0], data[keep, 1])
        ref = bin_points(x, y, fb[keep], RES_KM)
        got = fields[date]
        if not np.array_equal(np.isnan(got), np.isnan(ref)):
            _fail(f"bin {date}: NaN cells differ from the plain path's")
        fin = np.isfinite(ref)
        err = float(np.max(np.abs(got[fin] - ref[fin]) / np.abs(ref[fin]).clip(1e-300)))
        if not err <= 1e-9:
            _fail(f"bin {date}: relative deviation {err} from the plain path > 1e-9")
        checked[date] = {"rows": len(data), "valid_rows": int(keep.sum()),
                         "cells": int(fin.sum()), "max_rel_dev": err,
                         "parse_native_s": parse_s, "parse_genfromtxt_s": genfromtxt_s}
    return {"files": sum(len(v) for v in files.values()), "rows_a_file": BIN_ROWS,
            "write_s": write_s, "bin_command_s": bin_s, "days": checked}


def phase_chain(tmp: str, season: dict) -> dict:
    """Phase 10 (see the module docstring) on the season phase's season in
    ``tmp``. Returns the quicklook day's launches."""
    from optimalinterpolation_tpu_torch.data.prior import background_prior
    from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season
    from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season
    from optimalinterpolation_tpu_torch.io import quicklook
    from optimalinterpolation_tpu_torch.io.pickles import load_pickle
    from optimalinterpolation_tpu_torch.pipeline.daily import _prior_at_cells

    t_phase = time.perf_counter()
    ds = read_freeboard_season(tmp, RES_KM, "2018-2019")
    season_out = os.path.join(tmp, "season")
    gather = _chain_gather(ds)
    _phase("chain_gather", windows=gather, gather_s_by_wave=season["gather_s"],
           gather_s_by_wave_earlier=EARLIER_GATHER_S)
    binned = _chain_bin(tmp)
    _phase("chain_bin", **binned)

    # hypers: the season's four pickles, on the 25 km grid and regridded to 50 km
    hyp = os.path.join(tmp, "hypers_25km.npz")
    hypers, hypers_s = _cli(["hypers", "--indir", season_out, "--grid-res", str(RES_KM),
                             "--out", hyp])
    if hypers["days"] != len(SEASON_WINDOWS) or hypers["finite_cells"] == 0:
        _fail(f"hypers: {hypers}")
    grid50 = os.path.join(tmp, "grid50")
    make_synthetic_season(grid50, grid_res_km=50, n_days=N_DAYS, seed=7,
                          tracks_per_day=(10, 3, 8, 8), noise_std=0.1)
    hypers50, hypers50_s = _cli(["hypers", "--indir", season_out, "--grid-res", str(RES_KM),
                                 "--out", os.path.join(tmp, "hypers_50km.npz"), "--datapath",
                                 tmp, "--target-grid-res", "50", "--target-datapath", grid50,
                                 "--ocean-mask", "builtin"])
    if hypers50["shape"] != [160, 160] or hypers50["finite_cells"] == 0:
        _fail(f"hypers onto 50 km: {hypers50}")
    _phase("chain_hypers", grid_25km={**hypers, "seconds": hypers_s},
           regrid_50km_builtin_mask={**hypers50, "seconds": hypers50_s})

    # the quicklook day at the seasonal hypers and the background prior,
    # profiled, with its NetCDF
    logdir = os.path.join(tmp, "profile")
    with _netcdf_writes(quicklook) as write_s:
        res, date, launches, _, day_s, handler = _run_daily(
            tmp, ["--hypers", hyp, "--profile", logdir, "--quicklook"],
            prior_argv=("--prior-background", "9"))
    day = _Day(tmp, DAY)
    day.check_finite(res, date, ("interp", "interp_error", "lZ", "interp_smth",
                                 "interp_error_smth"))
    if launches["K1"] == 0 or launches["K2"] == 0 or launches["K3 value"] + launches["K3 grad"]:
        _fail(f"the quicklook day must launch K1 and K2 and not K3: {launches}")
    lon, lat = quicklook.grid_lonlat(ds.x, ds.y)
    netcdf = _check_netcdf(os.path.join(tmp, f"CS2S3_{date}_{RES_KM}km_quicklook.nc"), res,
                           date, (lon, lat), write_s)
    prior_cells, _ = _prior_at_cells(background_prior(ds.obs, lat, n_days=9),
                                     day.active.shape, day.active_ij)
    check = day.check_predict(res, date, "_smth", prior_cells)
    traces = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        _fail(f"--profile wrote {traces} under its log directory, not one trace")
    with open(os.path.join(logdir, traces[0])) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    names = {"K1": "k1_factor_invert_kernel", "K2": "k2_predict_kernel", "K3": "k3_nll_kernel"}
    in_trace = {k: {"events": sum(v in e["name"] for e in events),
                    "device_ms": sum(e["dur"] for e in events if v in e["name"]) / 1e3}
                for k, v in names.items()}
    if not (in_trace["K1"]["events"] and in_trace["K2"]["events"]):
        _fail(f"the trace names no K1 or no K2 kernel: {in_trace}")
    _phase("chain_quicklook", date=date, active_cells=int(day.active.sum()), day_wall_s=day_s,
           launches=launches, trace_kernels=in_trace,
           trace_device_ms_all_kernels=sum(e["dur"] for e in events) / 1e3,
           trace_kernel_events=len(events), trace_mb=os.path.getsize(
               os.path.join(logdir, traces[0])) / 1e6,
           rmse_vs_truth_m=day.rmse(res[f"{date}_interp_smth"]), netcdf=netcdf,
           buckets=[{"n": n, "cells": c, "wall_s": w} for n, c, _, w in handler.buckets],
           pass2_vs_f64={str(n): {"cells": c, "d_mean": dm, "d_std": ds_}
                         for n, (c, dm, ds_) in check.items()})

    # validate: the truth at every active cell of the four dates
    gx = np.load(os.path.join(tmp, f"x_{RES_KM}km.npy"))[:, 0]
    gy = np.load(os.path.join(tmp, f"y_{RES_KM}km.npy"))[0, :]
    pts = {"x": [], "y": [], "value": [], "date": []}
    errs = []
    for w in SEASON_WINDOWS:
        d = season["days"][w]
        ix, iy = d.active_ij
        pts["x"].append(gx[ix])
        pts["y"].append(gy[iy])
        pts["value"].append(d.truth[ix, iy])
        pts["date"].append(np.full(ix.shape, d.date, dtype="U8"))
        field = load_pickle(os.path.join(season_out, f"CS2S3_{d.date}_{RES_KM}km.pkl"))
        errs.append(field[f"{d.date}_interp"][ix, iy] - d.truth[ix, iy])
    points = os.path.join(tmp, "points.npz")
    np.savez(points, **{k: np.concatenate(v) for k, v in pts.items()})
    stats, validate_s = _cli(["validate", "--indir", season_out, "--datapath", tmp,
                              "--grid-res", str(RES_KM), "--points", points])
    err = np.concatenate(errs)
    pooled = float(np.sqrt(np.mean(err ** 2)))
    if not (stats["n"] == err.size and stats["coverage"] == 1.0
            and abs(stats["rmse"] - pooled) <= 1e-6):
        _fail(f"validate: {stats} against the pooled rmse {pooled} over {err.size} cells")
    _phase("chain_validate", seconds=validate_s, pooled_rmse_m=pooled,
           **{k: stats[k] for k in ("days", "n", "bias", "rmse", "corr", "coverage", "mean_z")})
    _phase("chain", seconds=time.perf_counter() - t_phase, launches=launches)
    return launches


# ---------------------------------------------------------------------------
# season_cli: the season command itself, at the seasonal hypers
# ---------------------------------------------------------------------------


def phase_season_cli(tmp: str, season: dict) -> dict:
    """Phase 16 (see the module docstring) on the season phase's season in
    ``tmp``, at the chain phase's seasonal hypers. Returns the first call's
    launches."""
    from optimalinterpolation_tpu_torch import cli
    from optimalinterpolation_tpu_torch.io.pickles import load_pickle
    from optimalinterpolation_tpu_torch.io.quicklook import grid_lonlat
    from optimalinterpolation_tpu_torch.pipeline import season as season_mod

    out = os.path.join(tmp, "season_cli")
    argv = ["season", "--datapath", tmp, "--grid-res", str(RES_KM), "--prior-mean", str(PRIOR),
            "--hypers", os.path.join(tmp, f"hypers_{RES_KM}km.npz"), "--days", "0:2",
            "--day-parallel", "2", "--outdir", out]
    calls = []
    for _ in range(2):  # the second call resumes both days
        _zero_counts()
        log = io.StringIO()
        with _netcdf_writes(season_mod) as write_s, contextlib.redirect_stdout(log):
            t0 = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        calls.append({"wall_s": wall, "launches": _counts(), "log": log.getvalue().splitlines(),
                      "write_s": write_s,
                      "files": {f: os.stat(os.path.join(out, f)).st_mtime_ns
                                for f in sorted(os.listdir(out))}})
    first, again = calls
    launches = first["launches"]
    kinds = [sum(f.endswith(k) for f in first["files"]) for k in ("km.pkl", "_quicklook.nc")]
    if kinds != [2, 2] or len(first["files"]) != 4:
        _fail(f"the season command wrote {sorted(first['files'])}, not 2 pickles and 2 NetCDFs")
    if launches["K1"] == 0 or launches["K2"] == 0 or launches["K3 value"] + launches["K3 grad"]:
        _fail(f"the season command at seasonal hypers must launch K1 and K2 and not K3: "
              f"{launches}")
    x = np.load(os.path.join(tmp, f"x_{RES_KM}km.npy"))
    y = np.load(os.path.join(tmp, f"y_{RES_KM}km.npy"))
    lonlat = grid_lonlat(x, y)
    cells, netcdf = 0, {}
    for w in (0, 1):
        day = season["days"][w]
        res = load_pickle(os.path.join(out, f"CS2S3_{day.date}_{RES_KM}km.pkl"))
        if len(res) != 15:
            _fail(f"season command, {day.date}: the pickle has {len(res)} keys, not 15")
        day.check_finite(res, day.date, ("interp", "interp_error", "lZ", "interp_smth",
                                         "interp_error_smth"))
        netcdf[day.date] = _check_netcdf(
            os.path.join(out, f"CS2S3_{day.date}_{RES_KM}km_quicklook.nc"), res, day.date,
            lonlat, first["write_s"])
        cells += int(day.active.sum())
    resumed = sum("skipping (resume)" in line for line in again["log"])
    if any(again["launches"].values()) or again["files"] != first["files"] or resumed != 2:
        _fail(f"the second season command did not resume both days untouched: launches "
              f"{again['launches']}, log {again['log']}")
    _phase("season_cli", argv=argv, windows=[0, 1], day_parallel=2, cells=cells,
           wall_s=first["wall_s"], cells_per_s=cells / first["wall_s"],
           netcdf_write_s=sum(v["write_s"] for v in netcdf.values()), netcdf=netcdf,
           launches=launches, log=first["log"],
           resume={"wall_s": again["wall_s"], "launches": again["launches"],
                   "files_rewritten": 0})
    return launches


# ---------------------------------------------------------------------------
# cell: the single-cell command, exact / Nystrom / SVGP
# ---------------------------------------------------------------------------

CELL_LANDMARKS = 925  # the reference demo's Nystrom rank (GP_example.ipynb cell-5)
CROSS_METHOD_M = 0.05  # tests/test_cli.py's gate between the cell's methods
SVGP_STEPS = 10_000  # the reference's SVGP settings: 50 inducing points, batch 100


def _f64_config(backend: str, **kw):
    """The float64 reference's optimizer settings for an objective as
    ``optimizer._resolve_backend`` names it, for a fit on the CPU (every
    wrapper there takes its kernel's plain twin): the plain autograd exact
    objective for K3's, the Nystrom objective itself for Nystrom's."""
    from optimalinterpolation_tpu_torch.models.optimizer import OptimizeConfig

    return OptimizeConfig(backend="nystroem" if backend.startswith("nystroem") else "xla",
                          nystroem_m=NYS_M, jitter=JITTER, **kw)


def _f64_fns(backend: str, x, y, m):
    """(value_fn, vg_fn) of the float64 reference of the objective
    ``backend`` (as ``optimizer._resolve_backend`` names it) on the device
    of ``x``: the plain autograd exact objective for K3's; for Nystrom's,
    the Nystrom objective with both factorizations by
    ``nystroem_gp.chol_inv_plain``, K1 taking float32 only."""
    from optimalinterpolation_tpu_torch.ops import nystroem_gp
    from optimalinterpolation_tpu_torch.ops.kernels import Kernel

    if not backend.startswith("nystroem:"):
        return _fns("xla", x, y, m)[:2]
    mi = int(backend.split(":")[1])
    kw = dict(kind=Kernel.MATERN32, jitter=JITTER, factor=nystroem_gp.chol_inv_plain)
    return (lambda h: nystroem_gp.gp_nll_nystroem(h, x, y, m, mi, **kw),
            lambda h: nystroem_gp.gp_nll_and_grad_nystroem(h, x, y, m, mi, **kw))


def _cell_cli(tmp: str, xy, *extra) -> tuple:
    """``cli.main(["cell", ...])`` at ``xy`` on the fit phase's season (its
    defaults: 300 km / 9 days, float32, 60 iterations, on the card), every
    launch count at 0 before and read after: (JSON line, launches)."""
    _zero_counts()
    line, _ = _cli(["cell", "--datapath", tmp, "--grid-res", str(RES_KM), "--day", str(DAY),
                    "--prior-mean", str(PRIOR), "--x", repr(float(xy[0])),
                    "--y", repr(float(xy[1])), *extra])
    torch.cuda.synchronize()
    return line, _counts()


def _log_hypers(line) -> np.ndarray:
    return np.log(np.array([line["hypers"][k] for k in HYPERS]))


def _exact_cell_check(day, xy, line, backend=None) -> dict:
    """The cell's prediction against the port's float64 ``exact_gp.predict``
    on the CPU at the hypers it printed (|d mean|, |d std| <= 1e-4 m) and,
    with ``backend`` (the objective the fit used), the float64 NLL of that
    objective at those hypers minus what a float64 L-BFGS fit of it
    reaches from there under the commands' stopping rule (<= NLL_MEAN)."""
    from optimalinterpolation_tpu_torch.models import exact_gp
    from optimalinterpolation_tpu_torch.models.optimizer import optimize_mll_batch

    x, z, m, xs = (torch.from_numpy(a).double() for a in day.cell(xy))
    lh = torch.from_numpy(_log_hypers(line))
    ref = exact_gp.predict(lh, x, z, xs[None], m, PRIOR, jitter=JITTER)
    out = {"n_points": line["n_points"], "capacity": int(x.shape[0]),
           "d_mean_vs_f64": abs(line["mean"] - float(ref.mean[0])),
           "d_std_vs_f64": abs(line["std"] - float(ref.std[0]))}
    if not (out["d_mean_vs_f64"] <= 1e-4 and out["d_std_vs_f64"] <= 1e-4):
        _fail(f"cell {line['method']}: the prediction is {out} off the float64 predict")
    if backend is not None:  # on the CPU: one row
        h, xr, yr, mr = lh[None], x[None], ((z - PRIOR) * m)[None], m[None]
        with torch.no_grad():
            at_fit = _f64_fns(backend, xr, yr, mr)[0](h)
        polished = optimize_mll_batch(h, xr, yr, mr, _f64_config(backend, max_iters=60,
                                                                  ftol_abs=1e-3))
        out.update(objective=backend, nll64_at_fit=float(at_fit[0]),
                   gap_vs_f64_fit=float(at_fit[0] - polished.nll[0]))
        if not out["gap_vs_f64_fit"] <= NLL_MEAN:
            _fail(f"cell {line['method']} N={out['capacity']}: the float64 NLL at the fitted "
                  f"hypers is {out['gap_vs_f64_fit']} nats above a float64 fit from there "
                  f"(> {NLL_MEAN})")
    return out


def _nystroem_cell_check(day, xy, line) -> dict:
    """The Nystrom cell's prediction at its fitted hypers and the command's
    landmarks against ``nystroem_predict`` in float64 on the CPU: within
    max(1e-3 m, 4 x the float32 CPU twin's own deviation)."""
    from optimalinterpolation_tpu_torch.models.nystroem import nystroem_predict

    arrays = day.cell(xy)
    valid = np.nonzero(arrays[2])[0]
    lmk = torch.from_numpy(np.random.default_rng(0).choice(
        valid, size=min(CELL_LANDMARKS, len(valid)), replace=False))
    lh = _log_hypers(line)

    def predict(dtype):
        x, z, m, xs = (torch.from_numpy(a).to(dtype) for a in arrays)
        return nystroem_predict(torch.from_numpy(lh).to(dtype), x, z, xs[None], lmk, m, PRIOR,
                                jitter=JITTER)

    ref, twin = predict(torch.float64), predict(torch.float32)
    out = {"landmarks": line["landmarks"], "n_points": line["n_points"]}
    for key in ("mean", "std"):
        r = float(getattr(ref, key)[0])
        out[f"d_{key}_vs_f64"] = abs(line[key] - r)
        out[f"d_{key}_twin32_vs_f64"] = abs(float(getattr(twin, key)[0]) - r)
        gate = max(1e-3, 4 * out[f"d_{key}_twin32_vs_f64"])
        if not (np.isfinite(line[key]) and out[f"d_{key}_vs_f64"] <= gate):
            _fail(f"cell nystroem: {key} {line[key]} is {out[f'd_{key}_vs_f64']} off the "
                  f"float64 Nystrom predict (> {gate}); the command printed {line}")
    return out


def phase_cell(tmp: str, day) -> dict:
    """Phase 11: the ``cell`` command at two cells of the fit phase's day:
    the active cell with the most points in the 1024 bucket (K3) and the
    first cell of the 4096 bucket (the rank-512 Nystrom objective, K1).
    Returns each kernel's launches over the phase's calls."""
    def pick(n, most):
        b = next(bb for bb in day.batches if bb.capacity == n)
        real = np.nonzero(b.cell_index >= 0)[0]
        r = real[np.argmax(b.mask[real].sum(axis=1))] if most else real[0]
        return day.cells_xy[b.cell_index[r]]

    from optimalinterpolation_tpu_torch.models.optimizer import OptimizeConfig, _resolve_backend

    xy_a, xy_b = pick(1024, True), pick(4096, False)
    calls = {}
    exact_a, calls["exact N=1024"] = _cell_cli(tmp, xy_a)
    exact_b, calls["exact N=4096"] = _cell_cli(tmp, xy_b)
    adam_a, calls["exact adam N=1024"] = _cell_cli(tmp, xy_a, "--optimizer", "adam")
    nys_a, calls["nystroem N=1024"] = _cell_cli(tmp, xy_a, "--method", "nystroem",
                                                "--landmarks", str(CELL_LANDMARKS))
    svgp_a, calls["svgp N=1024"] = _cell_cli(tmp, xy_a, "--method", "svgp", "--svgp-iters",
                                             str(SVGP_STEPS))
    k_a, k_b = calls["exact N=1024"], calls["exact N=4096"]
    if not (k_a["K3 value"] and k_a["K3 grad"]) or k_b["K1"] == 0 or k_b["K3 value"] + k_b[
            "K3 grad"]:
        _fail(f"the exact cells must fit through K3 (N = 1024) and K1 alone (N = 4096): "
              f"{k_a}, {k_b}")
    k_adam = calls["exact adam N=1024"]
    if k_adam["K3 grad"] != 60 or k_adam["K3 value"] != 1:
        _fail(f"the Adam cell must take 60 K3 value + gradient launches and one value: {k_adam}")
    checks = {
        "exact N=1024": _exact_cell_check(day, xy_a, exact_a,
                                          _resolve_backend(OptimizeConfig(), 1024)),
        "exact N=4096": _exact_cell_check(day, xy_b, exact_b,
                                          _resolve_backend(OptimizeConfig(), 4096)),
        "exact adam N=1024": _exact_cell_check(day, xy_a, adam_a),
        "nystroem N=1024": _nystroem_cell_check(day, xy_a, nys_a),
    }
    for name, line in (("nystroem", nys_a), ("svgp", svgp_a)):
        d = abs(line["mean"] - exact_a["mean"])
        checks[f"{name} N=1024"] = {**checks.get(f"{name} N=1024", {}),
                                    "d_mean_vs_exact": d}
        if not (d <= CROSS_METHOD_M and line["std"] > 0):
            _fail(f"cell {name}: mean {line['mean']} is {d} m from the exact mean "
                  f"{exact_a['mean']} (> {CROSS_METHOD_M}), or std {line['std']} <= 0")
    if not np.isfinite(svgp_a["elbo"]):
        _fail(f"cell svgp: the ELBO is {svgp_a['elbo']}")
    lines = {"exact N=1024": exact_a, "exact N=4096": exact_b, "exact adam N=1024": adam_a,
             "nystroem N=1024": nys_a, "svgp N=1024": svgp_a}
    _phase("cell", cells={"1024 bucket (most points)": [float(v) for v in xy_a],
                          "4096 bucket (first)": [float(v) for v in xy_b]},
           seconds={k: v["seconds"] for k, v in lines.items()},
           svgp_ms_a_step=svgp_a["seconds"] / SVGP_STEPS * 1e3, launches=calls,
           lines=lines, checks=checks)
    return {k: sum(c[k] for c in calls.values()) for k in k_a}


# ---------------------------------------------------------------------------
# adam: the full day fitted by Adam
# ---------------------------------------------------------------------------

def _adam_optimum(day, res, date) -> dict:
    """For 64 cells of each bucket, on the problem the Adam day fitted (the
    full row, valid points shuffled where the bucket is capped for L-BFGS,
    as the pipeline shuffles it), with the objective ``"auto"`` routes at
    that size: its float64 value at the day's hypers minus its float64
    value after a float64 Adam run of the same 60 steps from x0, both on
    the card (``_f64_fns``)."""
    from optimalinterpolation_tpu_torch.models import exact_gp, optimizer
    from optimalinterpolation_tpu_torch.models.optimizer import OptimizeConfig, _resolve_backend
    from optimalinterpolation_tpu_torch.pipeline.daily import _permute_valid_points

    out = {}
    for b in day.batches:
        n = b.capacity
        if min(n, day.cfg.opt_n_max) < n:
            _permute_valid_points(b)
        rows, gi, gj = day.rows(b)
        backend = _resolve_backend(OptimizeConfig(), n)
        lh = np.log(np.stack([res[f"{date}_{k}"][gi, gj] for k in HYPERS], 1))
        h, x, z, m = (torch.from_numpy(np.ascontiguousarray(a)).double().cuda()
                      for a in (lh, b.x[rows], b.z[rows], b.mask[rows]))
        y = z - PRIOR
        x0 = exact_gp.HYPER_INIT_LOG(RES_KM * 1e3, dtype=torch.float64,
                                     device="cuda").expand(len(rows), 5).contiguous()
        value_fn, vg_fn = _f64_fns(backend, x, y, m)
        with torch.no_grad():
            at_fit = value_fn(h)
            adam64 = optimizer._adam(value_fn, vg_fn, x0,
                                     OptimizeConfig(method="adam", max_iters=60))
        gap = at_fit - adam64.nll
        if not (torch.isfinite(at_fit).all() and torch.isfinite(adam64.nll).all()):
            _fail(f"N={n}: a float64 NLL at the Adam hypers or the float64 Adam run is not finite")
        out[n] = {"cells": len(rows), "objective": backend,
                  "gap": {"max": gap.max().item(), "median": gap.median().item(),
                          "mean": gap.mean().item(), "p95": gap.quantile(0.95).item()}}
    return out


def phase_adam(tmp: str, fit: dict) -> dict:
    """Phase 12: the fit phase's full day through ``cli.main(["daily", ...,
    "--optimizer", "adam"])`` (no seed pass, no cascade; every row fitted
    by 60 Adam steps from x0 at its bucket's full capacity, then smoothing
    and pass 2). Returns its launches."""
    torch.cuda.reset_peak_memory_stats()
    res, date, launches, _, day_s, handler = _run_daily(tmp, ["--optimizer", "adam"])
    peak = torch.cuda.max_memory_allocated() / 1e9
    stages = _stage_entries(handler.stages)
    day = _Day(tmp)  # buckets in the gather's order, shuffled below as the fit shuffled them
    n_active = int(day.active.sum())
    day.check_finite(res, date, [k[len(date) + 1:] for k in res])
    if min(launches.values()) == 0:
        _fail(f"the Adam day did not launch every kernel: {launches}")
    if any(e["stage"].startswith("seed:") or e["stage"] == "cascade" for e in stages):
        _fail(f"the Adam day ran a seed pass or a cascade: {[e['stage'] for e in stages]}")
    check = day.check_predict(res, date, "_smth")
    optimum = _adam_optimum(day, res, date)
    rmse = day.rmse(res[f"{date}_interp_smth"])
    _phase("adam", date=date, active_cells=n_active, cut="none: the whole day, 60 Adam steps",
           day_wall_s=day_s, cells_per_s_day=n_active / day_s,
           fit_wall_s=sum(e["wall_s"] for e in stages if e["stage"] == "opt"),
           predict_wall_s=sum(e["wall_s"] for e in stages if e["stage"] in ("predict", "pass2")),
           launches=launches, peak_mem_gb=peak, stages=stages,
           rmse_vs_truth_m=rmse, rmse_pass1_vs_truth_m=day.rmse(res[f"{date}_interp"]),
           rmse_lbfgs_day_this_run_m=fit["rmse_vs_truth_m"],
           pass2_vs_f64={str(n): {"cells": c, "d_mean": dm, "d_std": ds_}
                         for n, (c, dm, ds_) in check.items()},
           optimum_vs_f64_adam={str(n): v for n, v in optimum.items()})
    for n, v in optimum.items():
        if not (v["gap"]["median"] <= NLL_TYPICAL and v["gap"]["mean"] <= NLL_MEAN):
            _fail(f"{date} N={n}: the float64 NLL at the Adam hypers is {v['gap']['median']} "
                  f"(median) / {v['gap']['mean']} (mean) nats above a float64 Adam run's "
                  f"(> {NLL_TYPICAL} / {NLL_MEAN})")
    return launches


# ---------------------------------------------------------------------------
# devices: the fit phase's day and the quicklook day, cells sharded
# ---------------------------------------------------------------------------

KERNEL_NAMES = ("K1", "K2", "K3 value", "K3 grad")  # the order of _wrappers()
SHARD_TOL_M = 1e-6  # a sharded day's fields against the one-shard day's


class _GilProbe:
    """A thread that sleeps 1 ms at a time and measures how late it gets
    the interpreter lock back: while the shards run, the wait of any thread
    that asks for the lock. Its wake-ups over 0.3 s before the run are the
    idle baseline (the timer's own lateness)."""

    def __init__(self):
        import threading

        self.waits = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            t0 = time.perf_counter()
            time.sleep(1e-3)
            self.waits.append((t0, time.perf_counter() - t0 - 1e-3))

    def __enter__(self):
        self._thread.start()
        time.sleep(0.3)
        self.t_run = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)

    def report(self) -> dict:
        def summary(w):
            w = np.asarray(w) * 1e3
            return {"wakeups": len(w), "wait_ms_mean": float(w.mean()),
                    "wait_ms_p95": float(np.quantile(w, 0.95)),
                    "share_over_0.5ms": float((w > 0.5).mean())}

        return {"idle": summary([w for t, w in self.waits if t < self.t_run]),
                "during_run": summary([w for t, w in self.waits if t >= self.t_run])}


def _tallied_sharding(devices):
    """A ``CellSharding`` that also adds up, for each shard, the wall of its
    calls and the host synchronisations its thread made (through a wrapper
    of ``utils.counters.bump``; ``close()`` removes it)."""
    import collections
    import threading

    from optimalinterpolation_tpu_torch.parallel.mesh import CellSharding
    from optimalinterpolation_tpu_torch.utils import counters

    local, lock = threading.local(), threading.Lock()
    bump = counters.bump

    class Tallied(CellSharding):
        walls = collections.Counter()
        syncs = collections.Counter()

        def map(self, n_rows, fn, batch_multiple=1):
            shard_of = {rows.start: i for i, rows in self.split(n_rows, batch_multiple)}

            def timed(rows, dev):
                local.shard = shard_of[rows.start]
                t0 = time.perf_counter()
                try:
                    return fn(rows, dev)
                finally:
                    with lock:
                        self.walls[local.shard] += time.perf_counter() - t0
                    local.shard = None

            return super().map(n_rows, timed, batch_multiple)

        @staticmethod
        def close():
            counters.bump = bump

    def tallied_bump(owner, name, by=1):
        bump(owner, name, by)
        shard = getattr(local, "shard", None)
        if name == "host_syncs" and shard is not None:
            with lock:
                Tallied.syncs[shard] += by

    counters.bump = tallied_bump
    return Tallied(devices)


def _shard_launches(sharding) -> dict:
    """Launches of each kernel on each shard's stream, in the last run."""
    streams = [sharding.stream(i).cuda_stream for i in range(len(sharding))]
    return {name: [fn.streams[st] for st in streams]
            for name, fn in zip(KERNEL_NAMES, _wrappers())}


def _compare_days(got: dict, ref: dict, date: str) -> dict:
    """Each field of ``got`` against ``ref``: NaN cells equal, the largest
    deviation (absolute for the metre fields, relative for lZ and the
    hypers) and whether the field is bit-equal."""
    out = {}
    for key, r in ref.items():
        g = got[key]
        if not np.array_equal(np.isnan(g), np.isnan(r)):
            _fail(f"{key}: the sharded day's NaN cells differ from the one-shard day's")
        fin = np.isfinite(r)
        d = np.abs(g[fin] - r[fin])
        rel = not key.endswith(("_interp", "_interp_error", "_interp_smth",
                                "_interp_error_smth"))
        if rel:
            d = d / np.maximum(np.abs(r[fin]), 1e-300)
        out[key[len(date) + 1:]] = {"max_dev": float(d.max()) if d.size else 0.0,
                                    "relative": rel,
                                    "bit_equal": bool(np.array_equal(g, r, equal_nan=True))}
    return out


def _gate_sharded(cmp: dict, what: str, hypers_bit_equal: bool) -> None:
    for field, c in cmp.items():
        if hypers_bit_equal and field in HYPERS and not c["bit_equal"]:
            _fail(f"{what}: the {field} field is not bit-equal to the one-shard day's "
                  f"(max deviation {c['max_dev']})")
        if not c["max_dev"] <= SHARD_TOL_M:
            _fail(f"{what}: {field} deviates {c['max_dev']} from the one-shard day "
                  f"(> {SHARD_TOL_M}{' relative' if c['relative'] else ' m'})")


def phase_devices(tmp: str, day: _Day, quick: dict, fit: dict) -> dict:
    """Phase 13: (a) the fit phase's day with its cells on two shards of
    ``cuda:0`` (two host threads, two streams), (b) the slice phase's
    quicklook day on the same two shards, (c) the day through ``daily
    --devices N`` over every card where there are two or more. Returns (a)'s
    launches."""
    from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season
    from optimalinterpolation_tpu_torch.models import optimizer
    from optimalinterpolation_tpu_torch.models.optimizer import OptimizeConfig
    from optimalinterpolation_tpu_torch.pipeline.daily import DailyConfig, interpolate_daily

    ds = read_freeboard_season(tmp, RES_KM, "2018-2019")
    # the daily command's defaults, those of the fit phase's day
    cfg = DailyConfig(opt=OptimizeConfig(ftol_abs=1e-3), jitter=1e-6)
    log = logging.getLogger("optimalinterpolation_tpu_torch.pipeline.daily")
    log.setLevel(logging.INFO)
    out = {}
    for name, kw, ref in (("two_shards", {}, fit),
                          ("quicklook_two_shards", {"precomputed_hypers": quick["hypers_npz"]},
                           quick)):
        sharding = _tallied_sharding(["cuda:0", "cuda:0"])
        handler = _DailyLog()
        log.addHandler(handler)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        try:
            with _GilProbe() as probe:
                t0 = time.perf_counter()
                res = interpolate_daily(ds, DAY, PRIOR, cfg, cell_sharding=sharding, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            log.removeHandler(handler)
            sharding.close()
        launches = _counts()
        per_shard = _shard_launches(sharding)
        syncs = optimizer._lbfgs_segment.host_syncs
        res = res.to_reference_dict()
        date = day.date
        cmp = _compare_days(res, ref["result"], date)
        stages = _stage_entries(handler.stages)
        fit_s, predict_s = _fit_predict_walls(stages)
        rmse = day.rmse(res[f"{date}_interp_smth"])
        ref_rmse = day.rmse(ref["result"][f"{date}_interp_smth"])
        line = {
            "shards": ["cuda:0", "cuda:0"], "active_cells": int(day.active.sum()),
            "day_wall_s": wall, "fit_wall_s": fit_s, "predict_wall_s": predict_s,
            "host_syncs": syncs, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "launches_by_shard_stream": per_shard,
            "shard_wall_s": [sharding.walls[i] for i in range(2)],
            "shard_host_syncs": [sharding.syncs[i] for i in range(2)],
            "gil_probe": probe.report(), "rmse_vs_truth_m": rmse,
            "rmse_one_shard_m": ref_rmse, "vs_one_shard": cmp,
            "bucket_tiles": [list(b) for b in handler.buckets], "stages": stages,
        }
        if name == "two_shards":
            line["one_shard_this_run"] = {
                k: fit[k] for k in ("day_wall_s", "fit_wall_s", "predict_wall_s",
                                    "host_syncs", "peak_mem_gb", "stages")}
            line["one_shard_this_run"]["note"] = ("through cli.main: the season read and "
                                                  "the pickle write inside the day wall")
        else:
            line["one_shard_this_run"] = {"day_wall_s": None,
                                          "note": "the slice phase's line has its walls"}
        _phase("devices", case=name, **line)
        _gate_sharded(cmp, name, hypers_bit_equal=name == "two_shards")
        if not abs(rmse - ref_rmse) <= SHARD_TOL_M:
            _fail(f"{name}: rmse {rmse} against the one-shard day's {ref_rmse}")
        want = KERNEL_NAMES if name == "two_shards" else ("K1", "K2")
        if any(min(per_shard[k]) == 0 for k in want):
            _fail(f"{name}: not every kernel launched on each shard's stream: {per_shard}")
        if name != "two_shards" and (launches["K3 value"] or launches["K3 grad"]):
            _fail(f"{name}: the quicklook day launched K3: {launches}")
        out[name] = launches

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        _phase("devices", case="multi_card", multi_card=f"not run: {n_cards} card")
        return out["two_shards"]
    torch.cuda.reset_peak_memory_stats()
    res, date, launches, syncs, wall, handler = _run_daily(tmp, ["--devices", str(n_cards)])
    stages = _stage_entries(handler.stages)
    fit_s, predict_s = _fit_predict_walls(stages)
    cmp = _compare_days(res, fit["result"], date)
    streams = {name: sum(1 for v in fn.streams.values() if v)
               for name, fn in zip(KERNEL_NAMES, _wrappers())}
    rmse = day.rmse(res[f"{date}_interp_smth"])
    _phase("devices", case="multi_card", cards=n_cards, day_wall_s=wall, fit_wall_s=fit_s,
           predict_wall_s=predict_s, host_syncs=syncs, launches=launches,
           streams_with_launches=streams,
           peak_mem_gb_card0=torch.cuda.max_memory_allocated(0) / 1e9,
           rmse_vs_truth_m=rmse, vs_one_shard=cmp, stages=stages,
           one_shard_day_wall_s=fit["day_wall_s"])
    _gate_sharded(cmp, "multi_card", hypers_bit_equal=True)
    if not abs(rmse - fit["rmse_vs_truth_m"]) <= SHARD_TOL_M:
        _fail(f"multi_card: rmse {rmse} against the one-shard day's {fit['rmse_vs_truth_m']}")
    if any(v < n_cards for v in streams.values()):
        _fail(f"multi_card: not every kernel launched on {n_cards} streams: {streams}")
    return out["two_shards"]


# ---------------------------------------------------------------------------
# knobs: the JAX package's environment knobs on the fit phase's day
# ---------------------------------------------------------------------------

KNOBS = {"OI_BUCKET_128": "1", "OI_BUCKET_256": "1", "OI_CASCADE_NYS_M": "256"}
KNOB_NYS_M = int(KNOBS["OI_CASCADE_NYS_M"])


def phase_knobs(tmp: str, fit: dict) -> dict:
    """The fit phase's day with ``KNOBS`` set (module docstring, phase 14)."""
    from optimalinterpolation_tpu_torch.data.neighbors import DEFAULT_BUCKETS
    from optimalinterpolation_tpu_torch.pipeline.daily import DailyConfig

    with north_star.environ(KNOBS):
        kday = _Day(tmp)  # gathered into the six buckets the knobs give
        torch.cuda.reset_peak_memory_stats()
        res, date, launches, syncs, day_s, handler = _run_daily(tmp, [])
        peak = torch.cuda.max_memory_allocated() / 1e9
        rows_hist = _rows_histogram()
    if any(k in os.environ for k in KNOBS) or tuple(DailyConfig().buckets) != DEFAULT_BUCKETS:
        _fail("the knobs outlived the phase")
    stages = _stage_entries(handler.stages)
    for e, n in zip(stages, handler.stage_launches()):
        e["launches"] = n
    fit_s, predict_s = _fit_predict_walls(stages)
    n_active = int(kday.active.sum())
    rmse = kday.rmse(res[f"{date}_interp_smth"])
    buckets = {str(n): {"cells": cells, "tile": tile, "predict_wall_s": wall}
               for n, cells, tile, wall in handler.buckets[:len(kday.batches)]}
    _phase("knobs", knobs=KNOBS, date=date, active_cells=n_active, cells_by_bucket=buckets,
           day_wall_s=day_s, cells_per_s_day=n_active / day_s, fit_wall_s=fit_s,
           predict_wall_s=predict_s, host_syncs=syncs, launches=launches,
           rmse_vs_truth_m=rmse, fit_phase_rmse_vs_truth_m=fit["rmse_vs_truth_m"],
           fit_phase_day_wall_s=fit["day_wall_s"], peak_mem_gb=peak, stages=stages,
           k3_value_rows=rows_hist)

    caps = sorted(b.capacity for b in kday.batches)
    if caps != [128, 256, 512, 1024, 2048, 4096]:
        _fail(f"the knobs' day has buckets {caps}, not six")
    kday.check_finite(res, date, [k[len(date) + 1:] for k in res])
    cascades = [e for e in stages if e["stage"].endswith("cascade") and e["n"] >= 2 * KNOB_NYS_M]
    if not cascades or any((e["backend"], e.get("m")) != ("nystroem", KNOB_NYS_M)
                           for e in cascades):
        _fail(f"cascade stages not on Nystrom rank {KNOB_NYS_M}: {cascades}")
    if not all(e["launches"]["K1"] > 0 for e in cascades):
        _fail(f"K1 not launched inside every Nystrom cascade stage: {cascades}")
    fine = [e for e in stages if e["stage"].endswith("opt")]
    if any(e["backend"] != "fused" for e in fine):
        _fail(f"a fine stage left K3: {fine}")
    for n in (128, 256):
        k3 = sum(e["launches"]["K3 value"] + e["launches"]["K3 grad"] for e in fine
                 if e["n"] == n)
        k2 = sum(e["launches"]["K2"] for e in stages
                 if e["stage"] in ("predict", "pass2") and e["n"] == n)
        if not (k3 > 0 and k2 > 0):
            _fail(f"N = {n}: K3 {k3} and K2 {k2} launches in the knobs' day")
    check = kday.check_predict(res, date, "_smth")
    optimum = _check_optimum(kday, res, date)
    _phase("knobs_check",
           pass2_vs_f64={str(n): {"cells": c, "d_mean": dm, "d_std": ds_}
                         for n, (c, dm, ds_) in check.items()},
           optimum_vs_f64={str(n): v for n, v in optimum.items()})
    _gate_optimum(optimum, date)
    return {**launches, "rmse_vs_truth_m": rmse, "day_wall_s": day_s}


# ---------------------------------------------------------------------------
# northstar: bench.py's day (tools/north_star.py)
# ---------------------------------------------------------------------------

def north_star_day(ds, fyi, which: str, routing: str) -> dict:
    """``tools/north_star.py``'s day ``which`` under ``routing``, with every
    launch count at 0 before and read after; its gates (module docstring,
    phase 15)."""
    from optimalinterpolation_tpu_torch.models import optimizer

    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    out, stats = north_star.run_day(ds, fyi, which, routing)
    fit_s, predict_s = _fit_predict_walls(stats)
    out.update(fit_wall_s=fit_s, predict_wall_s=predict_s, launches=_counts(),
               host_syncs=optimizer._lbfgs_segment.host_syncs,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    _phase("northstar", **out)
    for msg in north_star.failures(out):
        _fail(msg)
    return out


def phase_northstar() -> dict:
    """The calibration day under both routings (module docstring, phase
    15). Returns the launches of each routing's day."""
    with tempfile.TemporaryDirectory() as tmp:
        ds, fyi = north_star.bench_season(tmp)
        return {routing: north_star_day(ds, fyi, "calibration", routing)["launches"]
                for routing in north_star.ROUTINGS}


def main() -> int:
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False")
    from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("device", phase_device)
    timed("build", phase_build)
    with tempfile.TemporaryDirectory() as tmp:
        # bench.py's synthetic season: seed 7, tracks (10, 3, 8, 8), noise 0.1
        make_synthetic_season(tmp, grid_res_km=RES_KM, n_days=N_DAYS, seed=7,
                              tracks_per_day=(10, 3, 8, 8), noise_std=0.1)
        day = _Day(tmp)
        k1 = timed("k1", phase_k1, day)
        k2 = timed("k2", phase_k2)
        k3 = timed("k3", phase_k3)
        quick = timed("slice", phase_slice, tmp, day)
        fit = timed("fit", phase_fit, tmp, day)
        knobs = timed("knobs", phase_knobs, tmp, fit)
        objectives = timed("objectives", phase_objectives, day)
        cell = timed("cell", phase_cell, tmp, day)
        adam = timed("adam", phase_adam, tmp, fit)
        devices = timed("devices", phase_devices, tmp, day, quick, fit)
    with tempfile.TemporaryDirectory() as tmp, _without_h5py():
        season = timed("season", phase_season, fit, tmp)
        chain = timed("chain", phase_chain, tmp, season)
        season_cli = timed("season_cli", phase_season_cli, tmp, season)
    northstar = timed("northstar", phase_northstar)
    _phase("seconds", **seconds)

    def paths(name):
        return {"launches": fit[name], "launches_by_path": {
            "quicklook": quick[name], "fit": fit[name],
            "season": {wave: season[wave][name] for wave in ("cold", "chained")},
            "chain": chain[name], "season_cli": season_cli[name], "cell": cell[name],
            "adam": adam[name],
            "devices (two shards)": devices[name], "knobs": knobs[name],
            **{f"northstar ({r} routing)": northstar[r][name] for r in north_star.ROUTINGS}}}

    k1_paths = paths("K1")
    k1_paths["launches_by_path"].update(objectives)
    waves = "season waves (cold, chained)"
    kernels = [
        {"name": "K1 factor_invert_128", "route": "cuda",
         "source": "optimalinterpolation_tpu_torch/csrc/k1_factor_invert.cu",
         "replaces": "optimalinterpolation_tpu/ops/blocked_gp.py:80", **k1_paths,
         "launched_by": ["blocked predict (quicklook, fit, season waves, chain, season_cli, "
                         "Adam day)",
                         "blocked objective (north star, JAX routing, N = 512)",
                         "Nystrom chol_inv (cell at N = 4096, Adam day at 2048 / 4096, "
                         "knobs' cascade at n = 512, north star's JAX routing at 1024)"], **k1},
        {"name": "K2 fused predict", "route": "cuda",
         "source": "optimalinterpolation_tpu_torch/csrc/k2_predict.cu",
         "replaces": "optimalinterpolation_tpu/ops/pallas_gp.py:795", **paths("K2"),
         "launched_by": ["fused predict (quicklook, fit, chain, season_cli, Adam day; knobs at "
                         "N = 128 / 256)", waves], **k2},
        {"name": "K3 fused NLL + gradient", "route": "cuda",
         "source": "optimalinterpolation_tpu_torch/csrc/k3_nll_grad.cu",
         "replaces": "optimalinterpolation_tpu/ops/pallas_gp.py:501",
         "launches": fit["K3 value"] + fit["K3 grad"],
         "launches_by_path": {"quicklook": 0, "fit": {"value": fit["K3 value"],
                                                      "grad": fit["K3 grad"]},
                              "season": {wave: {"value": season[wave]["K3 value"],
                                                "grad": season[wave]["K3 grad"]}
                                         for wave in ("cold", "chained")},
                              "chain": {"value": chain["K3 value"],
                                        "grad": chain["K3 grad"]},
                              "season_cli": {"value": season_cli["K3 value"],
                                             "grad": season_cli["K3 grad"]},
                              "cell": {"value": cell["K3 value"], "grad": cell["K3 grad"]},
                              "adam": {"value": adam["K3 value"], "grad": adam["K3 grad"]},
                              "devices (two shards)": {"value": devices["K3 value"],
                                                       "grad": devices["K3 grad"]},
                              "knobs": {"value": knobs["K3 value"], "grad": knobs["K3 grad"]},
                              **{f"northstar ({r} routing)": {"value": northstar[r]["K3 value"],
                                                              "grad": northstar[r]["K3 grad"]}
                                 for r in north_star.ROUTINGS}},
         "launched_by": ["fit (seed pass, cascade, fine stage; knobs at N = 128 / 256)", waves,
                         "cell (exact, L-BFGS and Adam, N <= 1024)",
                         "Adam day (every step at N <= 1024)"], **k3},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
