"""Tracing / profiling utilities (the reference's only instrumentation is
wall-clock prints, ``GPR_CS2S3.py:252,335``).

``StageTimer`` collects per-stage wall-clock and derived rates (cells/sec),
a copy of the JAX package's (``optimalinterpolation_tpu/utils/profiling.py``).
``trace`` takes the place of its ``jax.profiler`` trace: ``torch.profiler``
records host activity and, when a card is present, the card's kernels, and
writes one Chrome trace (TensorBoard- and Perfetto-loadable) under the log
directory when the block ends.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

__all__ = ["StageTimer", "trace"]


class StageTimer:
    """Accumulates named stage durations and per-stage item counts.

    >>> t = StageTimer()
    >>> with t.stage("optimize", items=1024): ...
    >>> t.summary()  # {'optimize': {'seconds': ..., 'items': 1024, 'rate': ...}}
    """

    def __init__(self, log: Optional[Callable[[str], None]] = None):
        self._acc: dict[str, list[float]] = {}
        self._items: dict[str, int] = {}
        self._log = log

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._acc.setdefault(name, []).append(dt)
            self._items[name] = self._items.get(name, 0) + items
            if self._log:
                rate = f" ({items / dt:.1f}/s)" if items else ""
                self._log(f"[{name}] {dt:.2f}s{rate}")

    def summary(self) -> dict:
        out = {}
        for name, times in self._acc.items():
            total = sum(times)
            items = self._items.get(name, 0)
            out[name] = {
                "seconds": round(total, 3),
                "calls": len(times),
                "items": items,
                "rate": round(items / total, 2) if items and total > 0 else None,
            }
        return out


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler``: CPU activity always, CUDA
    activity (kernels, copies) when ``torch.cuda.is_available()``. On exit
    it writes ``<host>_<pid>.<ns>.pt.trace.json`` under ``logdir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the trace
