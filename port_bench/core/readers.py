"""Helpers the metric files under ``port_bench/metrics/`` read a run with.
Each returns None where the run has nothing to read, and the metric is
then left out of the result line. Which cells read a metric is decided by
its ``workloads`` in ``BENCHMARK.json``, not here."""

from __future__ import annotations

from typing import Optional

FIT_STAGES = ("seed:cascade", "seed:opt", "cascade", "opt")
PREDICT_STAGES = ("predict", "pass2")


def per_day(run, total: float) -> Optional[float]:
    return total / len(run.days) if run.days else None


def stage_seconds_per_day(run, stages) -> Optional[float]:
    """Seconds a day of the program's ``stats`` entries of ``stages``."""
    found = [e["wall_s"] for d in run.days for e in d.stats if e["stage"] in stages]
    return per_day(run, sum(found)) if found else None


def span_seconds_per_day(run, step: str) -> Optional[float]:
    """Seconds a day of the benchmark's host spans around ``step``."""
    found = [d.spans[step] for d in run.days if step in d.spans]
    return per_day(run, sum(found)) if found else None


def cells_per_s(run) -> Optional[float]:
    """Active cells of the window's days over the window's seconds."""
    return run.cells() / run.window_s if run.days else None


def roofline(run, kernel: str) -> Optional[float]:
    """Percent: the least time the launches' work needs on the card
    (``port_bench/kernels/<kernel>.py``) over their device time by name."""
    summary = getattr(run, "trace_summary", None)
    if summary is None or not run.launches.get(kernel):
        return None
    k = next(m for m in run.cell.kernels() if m.NAME == kernel)
    device_s = sum(s for name, s in summary["by_name"].items() if k.TRACE_NAME in name)
    if device_s <= 0:
        return None
    bound_s = sum(max(b / k.PEAK_BYTES_PER_S, f / k.PEAK_FLOPS) for f, b in run.launches[kernel])
    return 100.0 * bound_s / device_s


def idle_share(run) -> Optional[float]:
    """Percent of the traced window in which no device activity ran."""
    summary = getattr(run, "trace_summary", None)
    if summary is None or summary["window_s"] <= 0 or not run.device_events:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
