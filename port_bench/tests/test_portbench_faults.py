"""A run with the timed path broken underneath comes out not correct, once
for each fault the cell can have; a sound run comes out correct. On the CPU
at the tiny size, the look for a card skipped (``run.measure`` directly).

The faults: the fit returns its start unchanged (fit cells); the fit
leaves the second half of the rows of each of its calls at their start
(fit cells: half of the batch left out); half of each bucket's rows left
without an answer; every predicted mean moved by 1 mm where it is produced;
a day that hands back the day before's fields (the season's state
unchanged). The exchange between cards does not exist on a one-card
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


FAULTS = {
    "fit_unchanged": ("pipeline.daily", "optimize_mll_chunked", _unchanged),
    "fit_half": ("pipeline.daily", "optimize_mll_chunked", _fit_half),
    "half_the_rows": ("pipeline.multiday", "_predict_bucket", _half),
    "answer_altered": ("pipeline.daily", "predict_batch", _altered),
    "day_unchanged": ("pipeline.multiday", "interpolate_days", _stale),
}
CASES = [(cell, fault) for cell in ("fit_chained", "fit_cold") for fault in FAULTS] + [
    ("quicklook_season", f) for f in ("half_the_rows", "answer_altered", "day_unchanged")]


@contextlib.contextmanager
def _broken(fault):
    import importlib

    mod_name, attr, make = FAULTS[fault]
    mod = importlib.import_module(f"optimalinterpolation_tpu_torch.{mod_name}")
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_is_not_correct(cell, fault):
    with _broken(fault):
        out = T.measure(spec.cell(cell), seed=97531, seconds=3.0)
    assert not out["correct"], out["numbers"]


@pytest.mark.parametrize("cell", ["fit_chained", "quicklook_season", "fit_cold"])
def test_a_sound_run_is_correct(cell):
    out = T.measure(spec.cell(cell), seed=97531, seconds=3.0)
    assert out["correct"], out["numbers"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [515151, 2**31 + 99, 8_888_888_881])
@pytest.mark.parametrize("fault", ["fit_half", "fit_unchanged"])
@pytest.mark.parametrize("name", ["fit_chained", "fit_cold"])
def test_fit_fault_on_the_card(name, fault, seed, monkeypatch):
    """A fit fault planted from the window's first day (the set-up's days are
    sound, so a chained day starts from yesterday's optimum), read at the
    cell's own size on one window day; prints the numbers and the gaps."""
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
