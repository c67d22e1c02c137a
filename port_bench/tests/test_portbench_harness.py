"""The harness on the CPU at a tiny size: what each driver's run loads, a
cell and a metric added as files, the result line's keys, and the command
without a card."""

import json
import os
import shutil
import subprocess
import sys

import portbench_tiny as T
import pytest

from port_bench.core import spec

ROOT = T.ROOT
CELLS = ["fit_chained", "quicklook_season", "fit_cold"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optimalinterpolation_tpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_run_loads_no_jax(name):
    """A tiny CPU run of the cell's driver in a fresh interpreter leaves no
    module of JAX or of the JAX package in ``sys.modules``."""
    code = (
        "import sys, json; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import portbench_tiny as T\n"
        "from port_bench.core import spec\n"
        "out = T.measure(spec.cell(%r))\n"
        "print(json.dumps({'correct': out['correct'],\n"
        "  'top': sorted({m.split('.')[0] for m in sys.modules})}))\n"
    ) % (str(ROOT), str(ROOT / "port_bench" / "tests"), name)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert not set(got["top"]) & set(FORBIDDEN)
    assert "optimalinterpolation_tpu_torch" in got["top"]


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import port_bench.reference.judge, port_bench.reference.control\n"
        "import port_bench.datagen.season, port_bench.datagen.fields\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    top = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not top & ({"optimalinterpolation_tpu_torch"} | set(FORBIDDEN))


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    """A new configuration, traffic, workload and metric, added as files
    (and entries of BENCHMARK.json) in a copy, run as a new cell that
    reports the new metric; no file of the harness is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    before = {p: p.read_bytes() for p in (root / "port_bench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((root / "port_bench/configs/cs2s3_25km_quicklook.json").read_text())
    conf.update(T.TINY, name="tiny_quicklook")
    (root / "port_bench/configs/tiny_quicklook.json").write_text(json.dumps(conf))
    (root / "port_bench/traffic/quicklook_early.json").write_text(json.dumps(
        {"driver": "quicklook", "first_window": 2, "warm_days": 1, "why": "early days"}))
    (root / "port_bench/workloads/tiny_ql.json").write_text(json.dumps(
        {"limits": {"missing_cells": 0, "gather_bad_cells": 0, "predict_err_m": 1e-4}}))
    (root / "port_bench/metrics/days_in_window.py").write_text(
        "def read(run):\n    return float(len(run.days))\n")
    bench["configs"].append({"name": "tiny_quicklook", "source": "a test", "reduced": [],
                             "file": "port_bench/configs/tiny_quicklook.json", "why": "test"})
    bench["workloads"].append({"name": "tiny_ql", "config": "tiny_quicklook",
                               "traffic": "quicklook_early", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "days_in_window", "unit": "days", "better": "higher",
                                "bound": 0.25, "source": "host_clock", "workloads": ["tiny_ql"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("tiny_ql", root=root)
    out = T.run_module().measure(cell, 7, 1.0, False, device="cpu")
    assert out["correct"]
    assert out["metrics"]["days_in_window"]["value"] >= 1.0
    # metrics whose ``workloads`` do not name the new cell stay out of it
    assert set(out["metrics"]) == {"days_in_window", "rmse_m", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_last_line_has_the_contracts_keys():
    run = T.run_module()
    cell = spec.cell("quicklook_season")
    out = T.measure(cell, trace=True)
    line, text = run.result_line(out, cell.limits)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
                                   "window_s"}
    assert set(line["checks"]) == set(cell.limits)
    assert len(text) == len(cell.limits)
    json.loads(json.dumps(line, allow_nan=False))
    line, _ = run.result_line({k: v for k, v in out.items() if k != "breakdown"}, cell.limits)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_the_command_exits_non_zero_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "fit_chained",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr
