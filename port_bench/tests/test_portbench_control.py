"""The control: the reference in the program's place, one precision step
below the configuration's (float32 with TF32 on, smoothing in float32),
judged by the cell's own numbers, must come out not correct.

On the card (``cuda`` marker; on that machine ``python3 -m pytest
port_bench/tests/test_portbench_control.py -m cuda -s``) it runs at each
cell's own size on three seeds and prints each reading. On the CPU, which
has no TF32, the tiny size checks that the control gives its numbers."""

import json
import math

import portbench_tiny as T
import pytest
import torch

from port_bench.core import session, spec
from port_bench.reference.control import control_numbers

CELLS = ["fit_chained", "quicklook_season", "fit_cold", "fit_chained_wave2"]


def _windows(cell, n_days):
    """The windows a run of ``cell`` starts with: its first wave, or, at one
    window a wave, its first ``n_days`` days."""
    first = int(cell.traffic["first_window"])
    if int(cell.traffic.get("day_parallel", 1)) == 1:
        return range(first, first + n_days)
    return session.Run(cell, 0, "", "cpu").windows(first)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [424242, 2**31 + 5, 7_777_777_777])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell = spec.cell(name)
    got = control_numbers(cell.config, cell.driver().FITS, seed, _windows(cell, 2),
                          device="cuda")
    print(json.dumps({"control": name, "seed": seed, **got}))
    assert any(v > cell.limits[k] for k, v in got.items()), got


@pytest.mark.parametrize("name", ["fit_chained", "quicklook_season", "fit_chained_wave2"])
def test_control_gives_its_numbers_on_the_cpu(name):
    cell = T.tiny(spec.cell(name))
    got = control_numbers(cell.config, cell.driver().FITS, 11, _windows(cell, 1),
                          device="cpu")
    assert set(got) <= set(cell.limits)
    assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
