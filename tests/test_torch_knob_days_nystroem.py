"""``OI_CASCADE_NYS_M``, the cascade's rank-M Nystrom objective: its
two-pass day against the JAX package's, float64 on the CPU, alone and under
``OI_NYSTROEM_MIN_N`` (``test_torch_env_knobs.py``'s ``CASES`` and
``check_knob_day``), and its reach into the seed pass.
"""

import pytest

from optimalinterpolation_tpu_torch.models import optimizer as TO
from optimalinterpolation_tpu_torch.pipeline import daily as TD

from .reference_flow import make_tiny_dataset
from .test_torch_env_knobs import _unset, check_knob_day  # noqa: F401  (_unset: autouse fixture)


@pytest.mark.parametrize("case", ["cascade_nys_m", "nys_m_under_nystroem_min_n"])
def test_knob_day_matches_jax(monkeypatch, case):
    check_knob_day(monkeypatch, case)


def test_cascade_nys_m_reaches_the_seed_pass(monkeypatch):
    """With spatial seeding, the seed pass's cascade (cold, ``warmstart_n``)
    and the main pass's (seeded, ``warmstart_n_seeded``) both launch on the
    rank-M Nystrom objective; every fine stage keeps its routing."""
    monkeypatch.setenv("OI_CASCADE_NYS_M", "128")
    cfg = TD.DailyConfig(dtype="float64", jitter=1e-6, spatial_seed_stride=2, seed_opt_n=0,
                         warmstart_n=256, warmstart_n_seeded=256, opt_n_max=288,
                         opt=TO.OptimizeConfig(max_iters=2, ftol_abs=1e-3))
    stats = []
    TD.interpolate_daily(make_tiny_dataset(coverage=0.3, active_radius_cells=3.2), 0, 0.2, cfg,
                         stats=stats, device="cpu")
    assert [(e["stage"], e["n"], e["backend"], e.get("m")) for e in stats
            if e["stage"].endswith(("cascade", "opt"))] == [
        ("seed:cascade", 256, "nystroem", 128), ("seed:opt", 288, "xla", None),
        ("cascade", 256, "nystroem", 128), ("opt", 288, "xla", None)]
