"""One run of a cell: set-up, the measured window of whole days, and what
the judge and the metric readers need afterwards.

The program is driven through ``pipeline.multiday.interpolate_days``, one
wave of windows a call (one window, or ``day_parallel`` of them strided as
``pipeline.season.run_season`` strides a season), and each day's pickle and
quicklook NetCDF are written as ``run_season`` writes them. The benchmark
wraps, from its own side, the program's gather
(``multiday.gather_neighborhoods``: a host span, and copies of the rows the
judge samples), the host steps of a wave (spans only) and, in a traced run,
the kernels' launch entry
(``ops._cuda.launch``: each launch's shapes, read from the arguments'
metadata, with no device read).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import defaultdict
from typing import Optional

import numpy as np

from port_bench.datagen import fields as F
from port_bench.datagen import season as S
from port_bench.reference import judge as J

# Host steps a span is recorded around: (module of the program, attribute).
HOST_STEPS = {
    "gather": ("pipeline.multiday", "gather_neighborhoods"),
    "window": ("pipeline.multiday", "flatten_window"),
    "fit": ("pipeline.multiday", "_fit_rows"),
    "predict": ("pipeline.multiday", "_predict_into"),
    "smooth": ("pipeline.multiday", "_smooth_fields"),
    "nearest_fill": ("pipeline.multiday", "nearest_fill"),
}


@dataclasses.dataclass
class Day:
    """One day the window ran. A wave's wall, stage entries, host syncs and
    host spans are its first day's; its other days carry none, so a total
    over the days divided by their number is the wave's cost a day."""

    w: int
    cells: int
    wall_s: float
    stats: list
    host_syncs: int
    result: object  # the program's DailyResult
    rows: list  # captured bucket rows for the judge
    spans: dict  # host step -> seconds
    wave: tuple  # the windows of the call that ran the day, in wave order


class Run:
    """A cell's run: ``cell`` from ``core.spec``; ``device`` "cuda" on the
    card, "cpu" only in the tests."""

    def __init__(self, cell, seed: int, tmpdir: str, device: str = "cuda"):
        self.cell, self.seed, self.tmp, self.device = cell, seed, tmpdir, device
        self.cfg = cell.config
        self.days: list = []
        self.spans: list = []  # (step, start ns, end ns), host clock (Unix ns)
        self.launches = defaultdict(list)  # kernel name -> [(flops, bytes)]
        self.state: dict = {}
        self._capture = None
        self._restore = []

    # ---- set-up --------------------------------------------------------
    def prepare(self) -> None:
        """The season (the configuration's), written and read by the
        program's reader; the share of cells and the hyper fields from the
        seed; the program's config."""
        import torch

        from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season
        from optimalinterpolation_tpu_torch.io.quicklook import grid_lonlat
        from optimalinterpolation_tpu_torch.models.optimizer import OptimizeConfig
        from optimalinterpolation_tpu_torch.ops.kernels import Kernel
        from optimalinterpolation_tpu_torch.pipeline.daily import DailyConfig

        c = self.cfg
        # as the command line sets them: no TF32 in the Cholesky chains
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rng_share, rng_fields, self.rng_sample = F.streams(self.seed, 3)
        self.season = S.make_season(c["grid_res_km"], c["n_days"], tuple(c["tracks_per_day"]),
                                    c["noise_std"], c["season_seed"])
        data = os.path.join(self.tmp, "season")
        S.write_season(self.season, data)
        self.ds = read_freeboard_season(data, c["grid_res_km"], S.SEASON)
        shape = self.season.x.shape
        self.share = (F.share_mask(shape, c["cell_share"], rng_share) if c["cell_share"] < 1.0
                      else np.ones(shape, bool))
        self.ds.sie = np.where(self.share[:, :, None], self.ds.sie, np.nan)
        self.hyper_fields = F.hyper_fields(self.season.x, self.season.y, c["hyper_constants"],
                                           c["hyper_log_amplitude"], c["hyper_waves"], rng_fields)
        self.daily_cfg = DailyConfig(
            window_days=c["window_days"], radius_km=c["radius_km"], kind=Kernel(c["kernel"]),
            opt=OptimizeConfig(method="lbfgs", max_iters=c["max_iters"], ftol_abs=c["ftol"]),
            buckets=tuple(c["buckets"]), dtype=c["dtype"], jitter=c["jitter"],
            warmstart_n=c["warmstart_n"], spatial_seed_stride=c["seed_stride"],
            opt_n_max=c["opt_n_max"],
        )
        self.lonlat = grid_lonlat(self.ds.x, self.ds.y)
        self.outdir = os.path.join(self.tmp, "out")
        os.makedirs(self.outdir, exist_ok=True)
        self._wrap_host_steps()

    def _wrap_host_steps(self) -> None:
        import importlib

        for step, (mod_name, attr) in HOST_STEPS.items():
            mod = importlib.import_module(f"optimalinterpolation_tpu_torch.{mod_name}")
            fn = getattr(mod, attr, None)
            if fn is None:
                continue
            wrapped = self._gather(fn) if step == "gather" else self._timed(step, fn)
            self._restore.append((mod, attr, fn))
            setattr(mod, attr, wrapped)

    def _timed(self, step, fn):
        def timed(*args, **kw):
            t0 = time.time_ns()
            try:
                return fn(*args, **kw)
            finally:
                self.spans.append((step, t0, time.time_ns()))
        return timed

    def _gather(self, fn):
        """The program's gather, with a span, and copies of the sampled rows
        of the wave's own buckets (not the seed sublattice's). A call is
        matched to the first window of the wave not yet seen whose active
        cells it gathers (the program gathers the wave's days in wave order).
        Each row keeps its window and its place in the combined bucket of
        its capacity (``pos``), where the real rows of the wave's earlier
        days come first, as ``multiday._concat_buckets`` stacks them."""
        def gather(train, cells_xy, *args, **kw):
            t0 = time.time_ns()
            out = fn(train, cells_xy, *args, **kw)
            cap = self._capture
            win = None if cap is None else next(
                (c for c in cap["windows"]
                 if not c["seen"] and np.array_equal(cells_xy, c["cells_xy"])), None)
            if win is not None:
                win["seen"] = True
                for b in out:
                    before = cap["filled"][b.capacity]
                    k = min(J.CHECK_CELLS_PER_BUCKET, b.n_valid_cells)
                    for r in np.sort(self.rng_sample.choice(b.n_valid_cells, k, replace=False)):
                        win["rows"].append({
                            "row": int(r), "pos": before + int(r), "w": win["w"],
                            "cell_index": int(b.cell_index[r]),
                            "x": b.x[r].copy(), "z": b.z[r].copy(), "mask": b.mask[r].copy(),
                            "xstar": b.xstar[r].copy()})
                    cap["filled"][b.capacity] += b.n_valid_cells
            self.spans.append(("gather", t0, time.time_ns()))
            return out
        return gather

    def record_launches(self) -> None:
        """In a traced run: each kernel launch's work, from its shapes."""
        from optimalinterpolation_tpu_torch.ops import _cuda

        by_entry = {k.ENTRY: k for k in self.cell.kernels()}
        orig = _cuda.launch

        def launch(entry, device, *args):
            k = by_entry.get(entry)
            if k is not None:
                self.launches[k.NAME].append(k.work(args))
            return orig(entry, device, *args)

        self._restore.append((_cuda, "launch", orig))
        _cuda.launch = launch

    def close(self) -> None:
        for mod, attr, fn in reversed(self._restore):
            setattr(mod, attr, fn)
        self._restore.clear()

    # ---- days ------------------------------------------------------------
    def n_windows(self) -> int:
        return self.cfg["n_days"] - self.cfg["window_days"] + 1

    def windows(self, j: int) -> list:
        """The windows of wave ``j`` of the season, as ``run_season``
        strides a season at the traffic's ``day_parallel`` (1 where it names
        none): windows ``j, j + n_waves, ...``, ``n_waves`` the windows over
        ``day_parallel``, rounded up. Empty past the last wave."""
        p = int(self.cell.traffic.get("day_parallel", 1))
        n = self.n_windows()
        n_waves = max(1, -(-n // p))
        return list(range(j, n, n_waves)) if 0 <= j < n_waves else []

    def wave(self, ws, **kwargs) -> list:
        """Windows ``ws`` as one wave, one call of ``interpolate_days``
        (``kwargs``: the driver's ``init_hypers``, a field set a window, or
        ``precomputed_hypers``), then each day's outputs written. Returns
        one Day a window; the wave's wall, stage entries, host syncs and
        host spans are counted once, on its first Day."""
        from optimalinterpolation_tpu_torch.io.pickles import save_pickle
        from optimalinterpolation_tpu_torch.io.quicklook import write_result_quicklook
        from optimalinterpolation_tpu_torch.models import optimizer
        from optimalinterpolation_tpu_torch.pipeline.multiday import interpolate_days

        ws = [int(w) for w in ws]
        windows = []
        for w in ws:
            active = np.nonzero(np.isfinite(self.ds.sie[:, :, w + self.daily_cfg.t_mid]))
            windows.append({"w": w, "cells": int(active[0].size), "seen": False, "rows": [],
                            "cells_xy": np.stack([self.ds.x[active], self.ds.y[active]],
                                                 axis=1)})
        self._capture = {"windows": windows, "filled": defaultdict(int)}
        stats: list = []
        syncs0 = optimizer._lbfgs_segment.host_syncs
        n_spans = len(self.spans)
        t0 = time.perf_counter()
        results = interpolate_days(self.ds, ws, [self.cfg["prior_mean"]] * len(ws),
                                   self.daily_cfg, stats=stats, device=self.device, **kwargs)
        tw = time.time_ns()
        for res in results:
            save_pickle(res.to_reference_dict(),
                        os.path.join(self.outdir, f"CS2S3_{res.date}_{self.ds.grid_res_km}km.pkl"))
            write_result_quicklook(res, *self.lonlat, self.ds.grid_res_km, self.outdir)
        self.spans.append(("write", tw, time.time_ns()))
        wall = time.perf_counter() - t0
        spans = defaultdict(float)
        for step, a, b in self.spans[n_spans:]:
            spans[step] += (b - a) / 1e9
        self._capture = None
        syncs = optimizer._lbfgs_segment.host_syncs - syncs0
        return [Day(w=win["w"], cells=win["cells"], wall_s=wall if i == 0 else 0.0,
                    stats=stats if i == 0 else [], host_syncs=syncs if i == 0 else 0,
                    result=res, rows=win["rows"], spans=dict(spans) if i == 0 else {},
                    wave=tuple(ws))
                for i, (win, res) in enumerate(zip(windows, results))]

    def window(self, driver, first: int, seconds: float) -> None:
        """Whole waves back to back from wave ``first``: a wave starts only
        if the previous wave's wall fits in what is left of ``seconds``. The
        window ends when its last wave ends."""
        self.t_window_ns = time.time_ns()
        t0 = time.perf_counter()
        j, ws = first, self.windows(first)
        while ws:
            days = driver.wave(self, ws)
            self.days.extend(days)
            elapsed = time.perf_counter() - t0
            j += 1
            ws = self.windows(j)
            if elapsed + days[0].wall_s > seconds:
                break
        self.window_s = time.perf_counter() - t0
        self.t_window_end_ns = time.time_ns()

    # ---- after the window --------------------------------------------------
    def cells(self) -> int:
        return sum(d.cells for d in self.days)

    def rmse_m(self) -> Optional[float]:
        """RMSE of the final mean field against the truth, over every active
        cell of the window's days."""
        t_mid = self.cfg["window_days"] // 2
        sq, n = 0.0, 0
        for d in self.days:
            ice = np.isfinite(self.ds.sie[:, :, d.w + t_mid])
            err = d.result.interp_smth[ice] - self.season.truth[d.w + t_mid][ice]
            sq += float(np.sum(err ** 2))
            n += int(ice.sum())
        return float(np.sqrt(sq / n)) if n else None

    def judged_days(self) -> list:
        """The window's days as the judge takes them, the program's results
        reduced to plain arrays."""
        out = []
        for d in self.days:
            r = d.result
            fields = {"interp": r.interp, "interp_error": r.interp_error,
                      "interp_smth": r.interp_smth, "interp_error_smth": r.interp_error_smth}
            for n in J.HYPER_NAMES:
                fields[n] = r.hypers[n]
                fields[n + "_smth"] = r.hypers_smth[n]
            out.append({"w": d.w, "wave": d.wave, "fields": fields, "rows": d.rows})
        return out
