#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``optimalinterpolation_tpu_torch``).

One command runs one cell once, from the root of a checkout, on a machine
with an NVIDIA card::

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It writes the configuration's synthetic season into ``$TMPDIR``, reads it
with the port's reader, draws from ``--seed`` the cell's share of cells, its
hyper fields and the judge's sample, warms one day, then runs whole days
back to back for ``--seconds`` through
``pipeline.multiday.interpolate_days``, each day's pickle and quicklook
NetCDF written as the ``season`` command writes them. After the window it
judges the outputs against the plain float64 reference
(``port_bench/reference/``), prints each compared number beside its limit as
the last lines of standard error, and prints one JSON line as the last line
of standard output: ``correct``, ``attempted`` and ``failed`` (active cells,
and those without a finite output), ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer ones with ``--trace 1``),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``.

It exits non-zero and prints no result where no card is found (there is no
CPU fallback), where the cell needs more cards than there are, or where
JAX or the JAX package was imported. The tests under ``port_bench/tests/``
call :func:`measure` on the CPU at a tiny size.

Layout of ``port_bench/`` (everything is found by the names in
``BENCHMARK.json``):

- ``configs/<config>.json``: a configuration as run (the deployment, its
  source, the cuts in ``reduced``, what was ``assumed``).
- ``traffic/<traffic>.json``: a traffic mix: the driver and its parameters
  (first window, warm days).
- ``workloads/<workload>.json``: a cell's limits of the compared numbers.
- ``drivers/<driver>.py``: ``FITS``, ``start(run)`` and ``day(run, w)``.
- ``metrics/<metric>.py``: ``read(run)`` returns the metric or None.
- ``kernels/<kernel>.py``: a kernel's launch entry, trace name, fixed
  peaks and ``work(args) -> (operations, bytes)`` from a launch's shapes.
- ``datagen/``: the frozen season generator, the share and the hyper fields.
- ``reference/``: the plain reference and the judge that decides ``correct``.
- ``core/``: the run (``session``), the trace's reduction (``trace``), the
  readers' helpers (``readers``) and the lookup by name (``spec``).

To add a cell, add its entry to ``BENCHMARK.json`` and the files it names:
a configuration, a traffic mix (a new driver only for a new kind of day), a
``workloads/<name>.json`` with its limits, and a ``metrics/<name>.py`` for
each new metric. No file already here needs an edit.

Build caches stay inside the checkout: the port builds its kernels into
``optimalinterpolation_tpu_torch/csrc/_build/`` and its host library into
``native/_build/``; Triton's cache, if a later kernel needs one, goes to
``port_bench/_cache/triton``.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "port_bench" / "_cache" / "triton"))

FORBIDDEN = ("jax", "jaxlib", "flax", "optimalinterpolation_tpu")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the port must not load,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def measure(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
            t_start: float = None) -> dict:
    """One run of ``cell``: set-up, the window, the metrics, the judge.
    Returns the result's fields (without ``checks``) and ``numbers``."""
    import torch

    from port_bench.core import session
    from port_bench.core import trace as tr
    from port_bench.reference.judge import judge

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device.startswith("cuda")
    tmp = tempfile.mkdtemp(prefix="port_bench_", dir=os.environ.get("TMPDIR"))
    run = session.Run(cell, seed, tmp, device)
    try:
        run.prepare()
        driver = cell.driver()
        driver.start(run)
        first = int(cell.traffic["first_window"])
        for w in range(first - int(cell.traffic["warm_days"]), first):
            driver.day(run, w)
        if on_card:
            torch.cuda.synchronize()
        run.setup_s = time.perf_counter() - t_start
        if trace:
            run.record_launches()
            with tr.profiled(run):
                run.window(driver, first, seconds)
            run.trace_summary = tr.summary(run)
        else:
            run.window(driver, first, seconds)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        metrics = {}
        for m in cell.metrics(trace):
            value = cell.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        run.close()
        days = run.judged_days()
        attempted = run.cells()
        day_cells = [d.cells for d in run.days]
        day_walls = [d.wall_s for d in run.days]
        run.days = []
        if on_card:
            torch.cuda.empty_cache()
        t_judge = time.perf_counter()
        gaps = []
        numbers = judge(run.season, run.share, cell.config, driver.FITS, days,
                        quicklook_hypers=None if driver.FITS else run.hyper_fields,
                        device=device, gaps_out=gaps)
        judge_s = time.perf_counter() - t_judge
    finally:
        run.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {
        "correct": all(numbers[k] <= cell.limits[k] for k in numbers),
        "attempted": attempted,
        "failed": int(numbers["missing_cells"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": int(cell.entry["chips"]), "memory_peak_bytes": int(peak)},
    }
    if trace:
        out["device"].update(busy_s=run.trace_summary["busy_s"],
                             window_s=run.trace_summary["window_s"])
        out["breakdown"] = run.trace_summary["breakdown"]
    out["numbers"] = numbers
    out["timing"] = {"setup_s": run.setup_s, "window_s": run.window_s, "judge_s": judge_s,
                     "days": [[d["w"], n, s] for d, n, s in zip(days, day_cells, day_walls)],
                     "fit_gaps_nats": gaps}
    return out


def result_line(out: dict, limits: dict) -> tuple:
    """The last line's object, keys in the contract's order with ``checks``
    last (each compared number with its limit), and the lines of standard
    error that give the same numbers."""
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    # a number that is not finite (no factor, no fit) is written as the
    # largest float, so the line stays plain JSON
    line["checks"] = {k: {"value": v if math.isfinite(v) else sys.float_info.max,
                          "limit": limits[k]} for k, v in out["numbers"].items()}
    text = [f"check {k} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}" for k, c in line["checks"].items()]
    return line, text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from port_bench.core import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("port_bench: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell.entry["chips"]):
        print(f"port_bench: {cell.name} needs {cell.entry['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    out = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", _T_START)
    found = forbidden_modules()
    if found:
        print(f"port_bench: modules loaded that the port must not load: {found}",
              file=sys.stderr)
        return 4
    print(f"port_bench: {cell.name} seed {args.seed} on {_card()}: "
          f"{json.dumps(out.pop('timing'))}", file=sys.stderr)
    line, checks = result_line(out, cell.limits)
    for text in checks:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
