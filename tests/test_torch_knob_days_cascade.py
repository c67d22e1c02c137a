"""The L-BFGS segment schedule's and the cascade drain's knobs: their
two-pass days against the JAX package's, float64 on the CPU
(``OI_SEG_SCHEDULE``, ``OI_CASCADE_SKIP_TOL``). Cases and checks are
``test_torch_env_knobs.py``'s ``CASES`` and ``check_knob_day``.
"""

import pytest

from .test_torch_env_knobs import _unset, check_knob_day  # noqa: F401  (_unset: autouse fixture)


@pytest.mark.parametrize("case", ["seg_schedule", "skip_tol"])
def test_knob_day_matches_jax(monkeypatch, case):
    check_knob_day(monkeypatch, case)
