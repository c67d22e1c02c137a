"""Limits of the suite under ``tests/``: a time limit, threads, tier-1's selection.

pytest loads this file (the rootdir's conftest) before ``tests/conftest.py``.
It acts on the tests under ``<rootdir>/tests`` only, and leaves others (say,
``port_bench/tests``) as they are.

- **Threads.** Under xdist the workers share the CPUs, and a thread pool sized
  to the whole machine in each worker oversubscribes them: OpenBLAS's idle
  threads spin. Six workers ran a parity test 5x slower than with one thread
  each, and the whole tier-1 run did not end in 1,470 s. So each worker gets
  ``CPUs // workers`` threads for OpenBLAS, torch and, at one thread, XLA.
  This runs at import, before ``tests/conftest.py`` builds XLA's flags.
- **Tier-1.** The JAX package's tests that run a whole day (each takes
  minutes on the CPU) are marked ``slow`` here (``SLOW``), so ``-m 'not
  slow'`` leaves them out; ``-m slow`` runs them.
- **A time limit.** Each phase of a test (setup, call, teardown) runs under a
  limit: the seconds of a ``timeout(seconds)`` marker, else
  ``SLOW_TIMEOUT_S`` for a ``slow`` test, else ``DEFAULT_TIMEOUT_S``.
"""

import faulthandler
import os
import signal
import sys

import pytest

DEFAULT_TIMEOUT_S = 300.0
SLOW_TIMEOUT_S = 3000.0

SLOW = {
    f"tests/{name}"
    for name in [
        "test_pipeline.py::test_pipeline_end_to_end",
        "test_pipeline.py::test_pipeline_sharded_matches_unsharded",
        "test_pipeline.py::test_spatially_varying_prior_field",
        "test_pipeline.py::test_quicklook_precomputed_hypers_path",
        "test_pipeline.py::test_pipeline_warmstart_path",
        "test_pipeline.py::test_cascade_drain_skips_settled_cells",
        "test_pipeline.py::test_init_hypers_chained_start_reaches_same_optimum",
        "test_pipeline.py::test_spatial_seeding_two_phase",
        "test_pipeline.py::test_init_hypers_nan_holes_nearest_filled",
        "test_cli.py::test_hypers_cli_quicklook_workflow",
        "test_cli.py::test_daily_cli_prior_background",
        "test_cli.py::test_validate_cli_skill_metrics",
        "test_cli.py::test_daily_cli_writes_pickle_and_quicklook",
        "test_multiday.py::test_wave_matches_serial_days",
        "test_multiday.py::test_wave_prior_fields_match_scalars",
        "test_multiday.py::test_wave_day_cell_mesh_sharding_matches_unsharded",
        "test_multiday.py::test_wave_seeding_and_cascade_run",
        "test_multiday.py::test_run_season_waves_matches_serial",
        "test_multiday.py::test_run_season_waves_chain_and_resume",
        "test_reference_flow.py::test_all_fifteen_fields_match",
        "test_reference_flow.py::test_smoothing_and_pass2_semantics_isolated",
    ]
}

WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if WORKERS:
    THREADS = max(1, len(os.sched_getaffinity(0)) // int(WORKERS))
    os.environ["OPENBLAS_NUM_THREADS"] = str(THREADS)  # OpenBLAS copies loaded from here on
    if THREADS == 1:  # six workers: the whole run 507 s against 616 s without
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
        ).strip()

    import threadpoolctl
    import torch

    threadpoolctl.threadpool_limits(THREADS)  # numpy's OpenBLAS, loaded by a plugin already
    torch.set_num_threads(THREADS)


def _ours(item):
    return item.path.is_relative_to(item.config.rootpath / "tests")


@pytest.hookimpl(tryfirst=True)  # before -m deselects
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


def _limited(item, when):
    """Run one phase of ``item`` under its time limit.

    ``signal.setitimer(ITIMER_REAL)`` arms the limit. On SIGALRM every
    thread's stack goes to stderr (the test's captured output), then the
    test fails with its id and limit. xdist runs tests in a worker's main
    thread, where the signal is delivered. Python handles it between
    bytecodes only, so a long native call (an XLA compile, a LAPACK or torch
    op) finishes before the test fails. A phase still running at twice its
    limit is stuck in native code (a JAX call queued behind a computation
    that an earlier failure left running, say): faulthandler's watchdog
    thread dumps every stack and ends the process, and xdist reports the
    test as crashed and starts a new worker.
    """
    if not _ours(item):
        yield
        return
    marker = item.get_closest_marker("timeout")
    if marker:
        limit = float(marker.args[0])
    else:
        limit = SLOW_TIMEOUT_S if item.get_closest_marker("slow") else DEFAULT_TIMEOUT_S

    def on_alarm(signum, frame):
        faulthandler.dump_traceback(file=sys.__stderr__, all_threads=True)
        pytest.fail(f"{item.nodeid} ({when}) exceeded its time limit of {limit:g} s",
                    pytrace=False)

    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(2 * limit, exit=True, file=sys.__stderr__)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    yield from _limited(item, "setup")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    yield from _limited(item, "call")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    yield from _limited(item, "teardown")
