"""A/B of the ``daily`` command between two checkouts of the port, on one card.

Makes ``chip_smoke.py``'s 9-day synthetic 25 km season once (seed 7, tracks
(10, 3, 8, 8), noise 0.1 m), then runs, in turns A, B, B, A (``--rounds``
repeats the four), one process per turn from the checkout's root: the
kernels are built first (not timed), then the full two-pass day
(``daily``, window 0, prior 0.15) and the quicklook day (``daily --hypers``,
constant hypers) are timed on the host clock through ``cli.main``, as
``chip_smoke.py`` drives them. Each turn prints one JSON line: the
checkout, both walls, the launch counts of the full day and the field sums
of both pickles (equal fields give equal sums).

    python3 tools/day_ab.py A_DIR B_DIR [--rounds N]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

_TURN = r"""
import contextlib, io, json, os, sys, time
import numpy as np
import torch
root, data = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
from optimalinterpolation_tpu_torch import cli
from optimalinterpolation_tpu_torch.io.pickles import load_pickle
from optimalinterpolation_tpu_torch.ops import _cuda, blocked_gp, fused_gp
_cuda.build()
counts = (blocked_gp._factor_invert, fused_gp.gp_predict, fused_gp.gp_nll,
          fused_gp.gp_nll_and_grad)
for fn in counts:
    fn.launches = 0
out = {"root": root}
for name, extra in (("day", []), ("quicklook", ["--hypers", os.path.join(data, "hypers.npz")])):
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["daily", "--datapath", data, "--grid-res", "25", "--day", "0",
                  "--prior-mean", "0.15", "--outdir", os.path.join(data, name), *extra])
    torch.cuda.synchronize()
    out[name + "_wall_s"] = time.perf_counter() - t0
    res = load_pickle(json.loads(buf.getvalue().strip().splitlines()[-1])["output"])
    out[name + "_field_sums"] = {k.split("_", 1)[1]: float(np.nansum(v)) for k, v in res.items()
                                 if k.endswith(("_interp_smth", "_interp_error_smth"))}
    if name == "day":
        out["day_launches"] = dict(zip(("K1", "K2", "K3 value", "K3 grad"),
                                       (fn.launches for fn in counts)))
print(json.dumps(out), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    a, b = os.path.abspath(args.a), os.path.abspath(args.b)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "a": a, "b": b}), flush=True)
    with tempfile.TemporaryDirectory() as data:
        sys.path.insert(0, a)
        import numpy as np

        from optimalinterpolation_tpu_torch.data.reader import read_freeboard_season
        from optimalinterpolation_tpu_torch.data.synthetic import make_synthetic_season

        make_synthetic_season(data, grid_res_km=25, n_days=9, seed=7,
                              tracks_per_day=(10, 3, 8, 8), noise_std=0.1)
        g = read_freeboard_season(data, 25, "2018-2019").sie.shape[0]
        hypers = dict(ell_x=2e5, ell_y=2e5, ell_t=2.0, sf2=0.03, sn2=0.005)
        np.savez(os.path.join(data, "hypers.npz"),
                 **{k: np.full((g, g), v) for k, v in hypers.items()})
        for _ in range(args.rounds):
            for root in (a, b, b, a):
                subprocess.run([sys.executable, "-c", _TURN, root, data], check=True, cwd=root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
