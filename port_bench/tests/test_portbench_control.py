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

from port_bench.core import spec
from port_bench.reference.control import control_numbers

CELLS = ["fit_chained", "quicklook_season", "fit_cold"]


def _config(cell):
    return {**cell.config, "first_window": cell.traffic["first_window"]}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [424242, 2**31 + 5, 7_777_777_777])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell = spec.cell(name)
    got = control_numbers(_config(cell), cell.driver().FITS, seed, device="cuda")
    print(json.dumps({"control": name, "seed": seed, **got}))
    assert any(v > cell.limits[k] for k, v in got.items()), got


@pytest.mark.parametrize("name", ["fit_chained", "quicklook_season"])
def test_control_gives_its_numbers_on_the_cpu(name):
    cell = T.tiny(spec.cell(name))
    got = control_numbers(_config(cell), cell.driver().FITS, 11, n_days=1, device="cpu")
    assert set(got) <= set(cell.limits)
    assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
