"""The bucket and subsample knobs' two-pass days against the JAX package's,
float64 on the CPU: ``OI_BUCKET_128`` / ``OI_BUCKET_256`` (the 128 bucket)
and ``OI_OPT_N_MAX`` (the fine stage's subsample). Cases and checks are
``test_torch_env_knobs.py``'s ``CASES`` and ``check_knob_day``.
"""

import pytest

from .test_torch_env_knobs import _unset, check_knob_day  # noqa: F401  (_unset: autouse fixture)


@pytest.mark.parametrize("case", ["buckets", "opt_n_max"])
def test_knob_day_matches_jax(monkeypatch, case):
    check_knob_day(monkeypatch, case)
