#!/usr/bin/env python3
"""Times of K2 and K3 at the shapes ``chip_smoke.py`` times, for one checkout.

Run on a machine with one NVIDIA card, from the root of the repository:

    python3 tools/time_fused_kernels.py [--root DIR] [--label NAME]
    python3 tools/time_fused_kernels.py --counts

``--root`` names the checkout whose ``optimalinterpolation_tpu_torch`` is
imported and built (default: this one), so that two builds can be compared
in one call, in turns (parent, change, change, parent), on the same seeded
inputs. Prints one JSON line: the label, the card's name and power limit,
ptxas's register and spill lines, and the mean milliseconds per launch by
CUDA events for K3 value and value + gradient at N = 128 / 512 / 1024 and
132 rows, K3 value at N = 1024 and 1 / 8 rows (a line-search launch), and K2
at N = 512 / 1024 and 64 cells; and K3's accuracy on ill-conditioned cells
(Matern-3/2, N = 1024, sn2 = 1e-9 sf2, so the diagonal is sf2 (1 + jitter)):
the largest relative value error and absolute gradient error against the
float64 twin, beside the float32 twin's.

``--counts`` needs no card: it prints, for the same shapes, the bound of
``chip_smoke.py::_bound`` (input and output bytes against operations, the
float32 and the 3xTF32 routes) and the device-memory scratch bytes K2 and K3
move per cell as the tile engine stages them (every streamed slice, resident
tile, accumulator load and store, the W blocks, the covariance build, the
solves' reads), which bound a full wave from below.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _k3_args(rng, b: int, n: int):
    import numpy as np
    import torch

    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.0, 0.05, (b, n))
    mask = (rng.random((b, n)) < 0.85).astype(np.float64)
    h = np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]) + rng.normal(0.0, 0.2, (b, 5))
    return [torch.tensor(a, dtype=torch.float32, device="cuda") for a in (h, x, y, mask)]


def _k2_args(rng, b: int, n: int):
    import numpy as np
    import torch

    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.1, 0.05, (b, n))
    mask = (rng.random((b, n)) < 0.85).astype(np.float64)
    h = np.tile(np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.005]), (b, 1))
    xs = rng.uniform(-1e5, 1e5, (b, 3)) * np.asarray([1, 1, 0]) + np.asarray([0.0, 0.0, 4.0])
    mean = np.full((b,), 0.15)
    return [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in (h, x, y, xs, mask, mean)]


def _ill_conditioned() -> dict:
    import numpy as np
    import torch

    from optimalinterpolation_tpu_torch.ops import fused_gp
    from optimalinterpolation_tpu_torch.ops.kernels import Kernel

    rng = np.random.default_rng(8)
    b, n = 4, 1024
    x = rng.uniform(-3e5, 3e5, (b, n, 3)) * np.asarray([1, 1, 1.2e-5])
    y = rng.normal(0.0, 0.05, (b, n))
    mask = (rng.random((b, n)) < 0.85).astype(np.float64)
    h = np.tile(np.log([1.5e5, 2.0e5, 2.0, 0.03, 0.03e-9]), (b, 1))
    args = [torch.tensor(a, dtype=torch.float32, device="cuda") for a in (h, x, y, mask)]
    kw = dict(kind=Kernel.MATERN32, jitter=1e-6)
    nll, grad = fused_gp.gp_nll_and_grad(*args, **kw)
    ref_v, ref_g = fused_gp.gp_nll_and_grad_plain(*[a.double() for a in args], **kw)
    twin_v, twin_g = fused_gp.gp_nll_and_grad_plain(*args, **kw)

    def err(v, g):
        return {"value_rel": ((v.double() - ref_v).abs() / ref_v.abs()).max().item(),
                "grad_abs": (g.double() - ref_g).abs().max().item()}

    return {"kernel": err(nll, grad), "twin32": err(twin_v, twin_g),
            "grad_inf_norm": ref_g.abs().max().item()}


def _scratch_bytes(n: int, grad: bool) -> int:
    """Bytes of (N, N) and (N, 128) scratch one K3 cell (or, without
    ``grad``, one K2 / K3-value cell) reads and writes in device memory:
    128x128 float32 tiles of 64 KB, counted as csrc/gp_common.cuh and
    csrc/k3_nll_grad.cu move them."""
    tile = 128 * 128 * 4
    nb = n // 128
    t = nb * (nb + 1) // 2 * tile  # covariance build: the lower block triangle
    for kb in range(nb):
        t += 3 * tile  # diagonal block read; L_kk and W_kk written
        t += (nb - 1 - kb) * 2 * tile  # panel: A_ik streamed, L_ik stored
        for ib in range(kb + 1, nb):  # trailing row: L_ik resident, then
            t += tile + (ib - kb) * 3 * tile  # L_jk streamed, A_ij in and out
    t += nb * (nb + 1) // 2 * tile + nb * tile  # forward solve: L and W read
    if not grad:
        return t
    t += nb * (nb + 1) // 2 * tile + nb * tile  # backward solve
    for jb in range(nb):
        t += 2 * tile  # U_jj = W_j^T
        for ib in range(jb + 1, nb):  # U_jk and L_ik streamed; W_i; U_ji stored
            t += (ib - jb) * 2 * tile + 2 * tile
    for jb in range(nb):  # Q: U_ik and U_jk streamed (once where ib == jb)
        for ib in range(jb, nb):
            t += (nb - ib) * (1 if ib == jb else 2) * tile
    return t


def _counts() -> dict:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import _bound

    out = {}
    for n in (128, 512, 1024):
        # as chip_smoke.py: inputs and outputs against N^3 / 3 FLOP per cell
        # for the Cholesky, N^3 with the gradient
        out[f"K3 value N={n} B=132"] = dict(
            **_bound(132 * (5 * n + 11) * 4, 132 * n ** 3 / 3, tf32x3=True),
            scratch_bytes_per_cell=_scratch_bytes(n, False))
        out[f"K3 grad N={n} B=132"] = dict(
            **_bound(132 * (5 * n + 11) * 4, 132 * float(n) ** 3, tf32x3=True),
            scratch_bytes_per_cell=_scratch_bytes(n, True))
    for b in (1, 8):
        out[f"K3 value N=1024 B={b}"] = _bound(b * (5 * 1024 + 11) * 4, b * 1024 ** 3 / 3,
                                                tf32x3=True)
    for n in (512, 1024):
        out[f"K2 N={n} B=64"] = dict(
            **_bound(64 * (5 * n + 14) * 4, 64 * n ** 3 / 3, tf32x3=True),
            scratch_bytes_per_cell=_scratch_bytes(n, False))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--counts", action="store_true")
    args = ap.parse_args()
    if args.counts:
        print(json.dumps(_counts()))
        return 0
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from optimalinterpolation_tpu_torch.ops import _cuda, fused_gp
    from optimalinterpolation_tpu_torch.ops.kernels import Kernel

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    lib = _cuda.build()
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    rng = np.random.default_rng(0)
    kw = dict(kind=Kernel.MATERN32, jitter=1e-6)
    times = {}
    for n in (128, 512, 1024):
        a = _k3_args(rng, 132, n)
        reps = 5 if n == 1024 else 10 if n == 512 else 40
        times[f"K3 value N={n} B=132"] = _ms(lambda: fused_gp.gp_nll(*a, **kw), reps)
        times[f"K3 grad N={n} B=132"] = _ms(lambda: fused_gp.gp_nll_and_grad(*a, **kw), reps)
    for b in (1, 8):
        a = _k3_args(rng, b, 1024)
        times[f"K3 value N=1024 B={b}"] = _ms(lambda: fused_gp.gp_nll(*a, **kw), 10)
    for n in (512, 1024):
        a = _k2_args(rng, 64, n)
        times[f"K2 N={n} B=64"] = _ms(lambda: fused_gp.gp_predict(*a, jitter=1e-6), 10)
    print(json.dumps({"label": args.label, "card": smi, "root": args.root,
                      "ptxas": ptxas, "ms": times, "ill_conditioned": _ill_conditioned()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
