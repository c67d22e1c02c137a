"""Waves of several windows in one call of ``interpolate_days`` on the CPU at
the tiny size: the judge's replay of the program's subsample over a wave's
combined bucket, and the wave cell's traffic at one window a wave against
``fit_chained``."""

import dataclasses

import numpy as np
import portbench_tiny as T

from port_bench.core import session, spec
from port_bench.reference import judge as J


def _kept_days(monkeypatch, in_window=None):
    """The window's days of the runs that follow (``measure`` drops them);
    ``in_window["on"]`` is set while a window runs."""
    kept = []
    window = session.Run.window
    in_window = {} if in_window is None else in_window

    def keep(self, *args, **kw):
        in_window["on"] = True
        try:
            window(self, *args, **kw)
        finally:
            in_window["on"] = False
        kept.extend(self.days)

    monkeypatch.setattr(session.Run, "window", keep)
    return kept


def test_replayed_subsample_is_the_programs_for_the_second_day(monkeypatch):
    """For the sampled rows of the wave's second day above ``opt_n_max``, the
    judge's replayed subsample holds the points, in order, that the
    program's ``_plan_fit`` left first in the combined bucket's row."""
    from optimalinterpolation_tpu_torch.pipeline import multiday

    in_window = {"on": False}
    kept = _kept_days(monkeypatch, in_window)
    plans = {}  # capacity -> the window's combined bucket after the shuffle
    plan_fit = multiday._plan_fit

    def plan_and_keep(full_b, *args, **kw):
        plan = plan_fit(full_b, *args, **kw)
        if in_window["on"]:
            assert full_b.capacity not in plans  # one wave in the window
            plans[full_b.capacity] = (full_b.x.copy(), full_b.z.copy(), full_b.mask.copy())
        return plan

    replays = []
    fit_subsample = J.fit_subsample

    def replay_and_keep(day, row, pts, buckets, n_max, earlier=()):
        sub = fit_subsample(day, row, pts, buckets, n_max, earlier)
        replays.append((row, sub, n_max, len(earlier)))
        return sub

    monkeypatch.setattr(multiday, "_plan_fit", plan_and_keep)
    monkeypatch.setattr(J, "fit_subsample", replay_and_keep)
    out = T.measure(spec.cell("fit_chained_wave2"), seed=24680, seconds=1.0)
    assert out["correct"], out["numbers"]
    (w1, w2) = kept[0].wave
    assert [d.w for d in kept] == [w1, w2]
    checked = 0
    for row, sub, n_max, n_earlier in replays:
        n = row["x"].shape[0]
        if row["w"] != w2 or n <= n_max:
            continue
        assert n_earlier == 1 and sub is not None
        assert row["pos"] > row["row"]  # the first day's rows come first
        x, z, m = plans[n]
        assert np.all(m[row["pos"], :n_max] == 1)
        prog = np.concatenate([x[row["pos"], :n_max], z[row["pos"], :n_max, None]], axis=1)
        np.testing.assert_array_equal(sub.astype(np.float32), prog)
        checked += 1
    assert checked > 0


def _fields(day):
    r = day.result
    return {"interp": r.interp, "interp_error": r.interp_error, "interp_smth": r.interp_smth,
            **{n: r.hypers[n] for n in J.HYPER_NAMES}}


def _same_rows(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            np.testing.assert_array_equal(ra[k], rb[k])


def test_one_window_a_wave_is_fit_chained(monkeypatch):
    """``fit_chained`` (no ``day_parallel``) against the wave cell's
    traffic at ``day_parallel`` 1: the same days,
    rows, stage entries, host syncs, outputs and compared numbers."""
    kept = _kept_days(monkeypatch)
    day_cell = spec.cell("fit_chained")
    wave_cell = spec.cell("fit_chained_wave2")
    wave_cell = dataclasses.replace(wave_cell, traffic={**wave_cell.traffic, "day_parallel": 1})
    outs = []
    for cell in (day_cell, wave_cell):
        outs.append(T.measure(cell, seed=13579, seconds=1.0))
    assert outs[0]["numbers"] == outs[1]["numbers"]
    assert outs[0]["attempted"] == outs[1]["attempted"]
    a, b = kept[: len(kept) // 2], kept[len(kept) // 2:]
    assert len(a) == len(b) == 1
    for da, db in zip(a, b):
        assert (da.w, da.cells, da.host_syncs, da.wave) == (db.w, db.cells, db.host_syncs, db.wave)
        strip = [{k: v for k, v in e.items() if k != "wall_s"} for e in da.stats]
        assert strip == [{k: v for k, v in e.items() if k != "wall_s"} for e in db.stats]
        _same_rows(da.rows, db.rows)
        fa, fb = _fields(da), _fields(db)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
