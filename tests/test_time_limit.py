"""The per-test time limit of the rootdir's ``conftest.py``.

Throwaway test files run through ``pytest`` in a subprocess, in a directory
that holds a copy of that conftest as its own rootdir's. A test that sleeps 5 s under a 1 s
``timeout`` marker fails within 10 s, its limit and id named, and a test
inside its limit passes. A test that the signal cannot reach (SIGALRM
blocked, as a thread inside a long native call is) ends its process at
twice its limit, every stack dumped.
"""

import os
import shutil
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = '''
import time

import pytest


@pytest.mark.timeout(1)
def test_sleeps_past_its_limit():
    time.sleep(5)


@pytest.mark.timeout(10)
def test_ends_inside_its_limit():
    time.sleep(0.1)
'''

STUCK = '''
import signal
import time

import pytest


@pytest.mark.timeout(1)
def test_stuck_where_the_signal_cannot_reach():
    print("started", time.time(), flush=True)
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(30)
'''


def _pytest(tmp_path, source, *args):
    shutil.copy(os.path.join(REPO, "conftest.py"), tmp_path / "conftest.py")
    (tmp_path / "pytest.ini").write_text("[pytest]\nmarkers = timeout(seconds)\n")
    (tmp_path / "tests").mkdir()
    probe = tmp_path / "tests" / "test_probe.py"
    probe.write_text(source)
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider", "-p", "no:xdist",
         "-p", "no:randomly", "-q", *args, str(probe)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)


def test_time_limit_fails_a_test_that_overruns(tmp_path):
    xml = tmp_path / "probe.xml"
    proc = _pytest(tmp_path, PROBE, f"--junitxml={xml}")
    assert proc.returncode == 1, proc.stdout + proc.stderr  # one test failed
    cases = {c.get("name"): c for c in ET.parse(xml).getroot().iter("testcase")}
    over, inside = cases["test_sleeps_past_its_limit"], cases["test_ends_inside_its_limit"]
    failure = over.find("failure")
    assert failure is not None, proc.stdout
    assert float(over.get("time")) < 10
    assert "test_probe.py::test_sleeps_past_its_limit (call) exceeded its time limit of 1 s" \
        in failure.get("message")
    assert "time.sleep(5)" not in failure.get("message")  # pytrace=False: the message alone
    # every thread's stack, in the failing test's captured stderr
    assert "Captured stderr call" in proc.stdout
    line = PROBE.splitlines().index("    time.sleep(5)") + 1
    assert f'test_probe.py", line {line} in test_sleeps_past_its_limit' in proc.stdout
    assert len(inside) == 0  # passed: no failure, error or skip element


def test_time_limit_ends_a_process_the_signal_cannot_reach(tmp_path):
    proc = _pytest(tmp_path, STUCK, "-s")  # -s: the dump reaches the pipe, not a capture file
    ended = time.time()
    assert proc.returncode == 1, proc.stdout + proc.stderr  # faulthandler's exit status
    started = float(proc.stdout.split("started ")[1].split()[0])
    assert ended - started < 15  # the test's 30 s sleep did not run out
    assert "Timeout (0:00:02)!" in proc.stderr
    line = STUCK.splitlines().index("    time.sleep(30)") + 1
    assert f'test_probe.py", line {line} in test_stuck_where_the_signal_cannot_reach' \
        in proc.stderr
    assert " passed" not in proc.stdout and " failed" not in proc.stdout  # no summary
