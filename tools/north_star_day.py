#!/usr/bin/env python3
"""The North star's guard on ``bench.py``'s full-scale day, on one NVIDIA card.

Run from the root of the repository:

    python3 tools/north_star_day.py

It builds ``bench.py``'s 16-day synthetic season with the port's own modules
(``tools/north_star.py``) and runs its full-scale day 0 (17,149 active
cells) through ``interpolate_daily`` (``chip_smoke.north_star_day``: the
launches counted) under the JAX package's routing
(``OI_BLOCKED_MIN_N=512 OI_NYSTROEM_MIN_N=1024``) and then the port's, each
with ``chip_smoke.py`` phase 15's gates: 15 keys, every active cell finite,
the JAX routing's stages on their objectives, and rmse against the JAX
package's recorded 0.0116 m (within 0.55 mm under the JAX routing, at most
0.0116 + 0.00055 m under the port's). One JSON line a day (cells, walls,
launches, host syncs, peak memory, rmse, the fitting stages), then the
card's name and power limit from ``nvidia-smi``. Any failed gate exits
non-zero.
"""

from __future__ import annotations

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tools import north_star  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        cs._fail("torch.cuda.is_available() is False")
    smi = cs.phase_device()
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        ds, fyi = north_star.bench_season(tmp)
        for routing in north_star.ROUTINGS:
            cs.north_star_day(ds, fyi, "full", routing)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
