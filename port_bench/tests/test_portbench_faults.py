"""A run with the timed path broken underneath comes out not correct, once
for each fault the cell can have; a sound run comes out correct. On the CPU
at the tiny size, the look for a card skipped (``run.measure`` directly).

The faults: the fit returns its start unchanged (fit cells); the fit
leaves the second half of the rows of each of its calls at their start
(fit cells: half of the batch left out); half of each bucket's rows left
without an answer; every predicted mean moved by 1 mm where it is produced;
a day that hands back the day before's fields (the season's state
unchanged). A wave of several days has two more: the fit leaves the rows of
the wave's later days at their start, and a later day hands back its wave
partner's fields. The exchange between cards does not exist on a one-card
cell."""

import contextlib
import dataclasses

import numpy as np
import portbench_tiny as T
import pytest
import torch

from port_bench.core import spec


def _unchanged(orig):
    from optimalinterpolation_tpu_torch.models.optimizer import OptimizeResult

    def fit(h0, *args, **kw):
        b = h0.shape[0]
        return OptimizeResult(h0.clone(), torch.zeros(b, dtype=h0.dtype),
                              torch.zeros(b, dtype=torch.int64), torch.ones(b, dtype=torch.bool))
    return fit


def _fit_half(orig):
    def fit(h0, *args, **kw):
        res = orig(h0, *args, **kw)
        b = h0.shape[0]
        lh = res.log_hypers.clone()
        lh[b // 2:] = h0[b // 2:].to(lh)
        return res._replace(log_hypers=lh)
    return fit


def _half(orig):
    def predict(b, *args, **kw):
        out, tile = orig(b, *args, **kw)
        out[:, len(b) // 2:] = np.nan
        return out, tile
    return predict


def _altered(orig):
    def predict(*args, **kw):
        r = orig(*args, **kw)
        return r._replace(mean=r.mean + 1e-3)
    return predict


def _stale(orig):
    seen = []

    def days(*args, **kw):
        res = orig(*args, **kw)
        seen.append(res)
        if len(seen) == 1:
            return res
        return [dataclasses.replace(old, date=new.date) for old, new in zip(seen[-2], res)]
    return days


def _later_days_unfitted():
    """Patches that leave the fit's rows of a wave's later days at their
    start: the wave's offsets (``multiday._offsets``) say where its first
    day's cells end in the combined buckets' ``cell_index``."""
    first_day = {"cells": 0}

    def offsets(orig):
        def wrapped(ctxs):
            out = orig(ctxs)
            first_day["cells"] = int(out[1])
            return out
        return wrapped

    def fit_rows(orig):
        def fit(b, h0, *args, **kw):
            lh = np.array(orig(b, h0, *args, **kw))
            later = b.cell_index >= first_day["cells"]
            lh[later] = h0[later]
            return lh
        return fit

    return [("pipeline.multiday", "_offsets", offsets),
            ("pipeline.multiday", "_fit_rows", fit_rows)]


def _partner(orig):
    def days(*args, **kw):
        res = orig(*args, **kw)
        return res[:1] + [dataclasses.replace(res[0], date=r.date) for r in res[1:]]
    return days


FAULTS = {
    "fit_unchanged": ("pipeline.daily", "optimize_mll_chunked", _unchanged),
    "fit_half": ("pipeline.daily", "optimize_mll_chunked", _fit_half),
    "half_the_rows": ("pipeline.multiday", "_predict_bucket", _half),
    "answer_altered": ("pipeline.daily", "predict_batch", _altered),
    "day_unchanged": ("pipeline.multiday", "interpolate_days", _stale),
    "later_days_unfitted": _later_days_unfitted(),
    "partner_fields": ("pipeline.multiday", "interpolate_days", _partner),
}
ONE_DAY = ("fit_unchanged", "fit_half", "half_the_rows", "answer_altered", "day_unchanged")
CASES = [(cell, fault) for cell in ("fit_chained", "fit_cold") for fault in ONE_DAY] + [
    ("quicklook_season", f) for f in ("half_the_rows", "answer_altered", "day_unchanged")] + [
    ("fit_chained_wave2", f) for f in ("fit_half", "later_days_unfitted", "partner_fields")]


@contextlib.contextmanager
def _broken(fault):
    import importlib

    patches = FAULTS[fault] if isinstance(FAULTS[fault], list) else [FAULTS[fault]]
    undo = []
    try:
        for mod_name, attr, make in patches:
            mod = importlib.import_module(f"optimalinterpolation_tpu_torch.{mod_name}")
            undo.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, make(getattr(mod, attr)))
        yield
    finally:
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_is_not_correct(cell, fault):
    with _broken(fault):
        out = T.measure(spec.cell(cell), seed=97531, seconds=3.0)
    assert not out["correct"], out["numbers"]


@pytest.mark.parametrize("cell", ["fit_chained", "quicklook_season", "fit_cold",
                                  "fit_chained_wave2"])
def test_a_sound_run_is_correct(cell):
    out = T.measure(spec.cell(cell), seed=97531, seconds=3.0)
    assert out["correct"], out["numbers"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [515151, 2**31 + 99, 8_888_888_881])
@pytest.mark.parametrize("fault", ["fit_half", "fit_unchanged"])
@pytest.mark.parametrize("name", ["fit_chained", "fit_cold", "fit_chained_wave2"])
def test_fit_fault_on_the_card(name, fault, seed, monkeypatch):
    """A fit fault planted from the window's first wave (the set-up's waves
    are sound, so a chained day starts from yesterday's optimum), read at
    the cell's own size on one window wave; prints the numbers and the
    gaps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    from optimalinterpolation_tpu_torch.pipeline import daily

    from port_bench.core import session

    planted = {"on": False}
    window, fit = session.Run.window, daily.optimize_mll_chunked
    broken = FAULTS[fault][2](fit)

    def window_planted(self, *args, **kw):
        planted["on"] = True
        return window(self, *args, **kw)

    monkeypatch.setattr(session.Run, "window", window_planted)
    monkeypatch.setattr(daily, "optimize_mll_chunked",
                        lambda *a, **kw: (broken if planted["on"] else fit)(*a, **kw))
    out = T.run_module().measure(spec.cell(name), seed, 1.0, False, device="cuda")
    print(json.dumps({"fault": fault, "cell": name, "seed": seed, **out["numbers"],
                      "fit_gaps_nats": out["timing"]["fit_gaps_nats"]}))
    assert not out["correct"], out["numbers"]
