"""Reading the traced window: ``torch.profiler`` records the card's activity
(kernels, copies, sets) over the window; this reduces it to the device's
busy seconds (the union of the activity intervals, so overlapping streams
count once), the device seconds of each kernel by name, and the idle gaps
labelled by the host step the benchmark's spans say was running.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import numpy as np


@contextlib.contextmanager
def profiled(run):
    """Trace the block (the card's activity only; a CPU run, in the tests,
    records host activity and finds no device event), then keep its device
    events on ``run.device_events``: (start ns, end ns, name), host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]) as prof:
        yield
        if on_card:
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    run.device_events = [(e.start_ns(), e.end_ns(), e.name())
                         for e in prof.profiler.kineto_results.events()
                         if e.device_type() == cuda]


def union(events, t0: int, t1: int) -> list:
    """Merged [start, end) intervals of ``events`` clipped to [t0, t1]."""
    spans = sorted((max(a, t0), min(b, t1)) for a, b, _ in events if b > t0 and a < t1)
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summary(run) -> dict:
    """busy_s, window_s, device seconds by kernel name and the breakdown."""
    t0, t1 = run.t_window_ns, run.t_window_end_ns
    busy = union(run.device_events, t0, t1)
    by_name = defaultdict(float)
    for a, b, name in run.device_events:
        by_name[name] += (b - a) / 1e9
    edges = np.array([t0] + [x for iv in busy for x in iv] + [t1], np.int64)
    starts, ends = edges[0::2], edges[1::2]
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    mids = (starts + ends) // 2
    labels = np.zeros(len(mids), np.int64)  # 0: no span of the benchmark's
    names = ["other host work"]
    for step, s0, s1 in sorted(run.spans, key=lambda s: s[1]):
        if step not in names:
            names.append(step)
        lo, hi = np.searchsorted(mids, s0), np.searchsorted(mids, s1)
        labels[lo:hi] = names.index(step)  # later starts win: the inner span
    idle = np.bincount(labels, weights=(ends - starts) / 1e9, minlength=len(names))
    gaps = {names[i]: float(idle[i]) for i in range(len(names)) if idle[i] > 0}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "by_name": dict(by_name),
        "breakdown": {
            "device_ops": [[name[:120], s] for name, s in top],
            "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
        },
    }
