"""A cell at a size the CPU tests can hold: a 200 km grid (40 x 40), a
600 km radius and buckets of 128-512 points, so that the rows above
``opt_n_max`` (the seeded subsample) and above the largest bucket (the
nearest points) both occur."""

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(grid_res_km=200, n_days=14, radius_km=600.0, buckets=[128, 256, 512],
            opt_n_max=256, warmstart_n=128, max_iters=30)
# rows the judge recomputes in each bucket of a tiny day
TINY_CHECK_CELLS = 4


def tiny(cell):
    """``cell`` cut to the tiny size, its window starting at window 2."""
    return dataclasses.replace(cell, config={**cell.config, **TINY},
                               traffic={**cell.traffic, "first_window": 2})


def measure(cell, seed=20251018, seconds=1.0, trace=False):
    """One CPU run of the cell at the tiny size through ``run.measure``."""
    from port_bench.reference import judge

    check = judge.CHECK_CELLS_PER_BUCKET
    judge.CHECK_CELLS_PER_BUCKET = TINY_CHECK_CELLS
    try:
        return run_module().measure(tiny(cell), seed, seconds, trace, device="cpu")
    finally:
        judge.CHECK_CELLS_PER_BUCKET = check


def run_module():
    """``port_bench/run.py`` as a module."""
    from port_bench.core.spec import load_module

    return load_module(ROOT / "port_bench" / "run.py")
