"""The test harness itself: the per-test time limit (tests/time_limit.py)
and the top-level conftest's sizing of each pytest-xdist worker's CPU
threads, each checked in a pytest run of its own on a file written under
tmp_path."""

import os
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
PYPROJECT = os.path.join(ROOT, "pyproject.toml")

LIMITED = '''
import signal
import time

import time_limit

time_limit.DEFAULT_SECONDS = 2


def test_sleeps_past_its_limit():
    time.sleep(60)


def test_passes():
    pass
'''

SIZED = '''
import os

import torch


def test_worker_threads(pytestconfig):
    k = max(1, os.cpu_count() // 2)
    sizing = pytestconfig.pluginmanager.get_plugin("conftest")
    assert sizing.WORKERS == 2 and sizing.THREADS == k
    assert pytestconfig.pluginmanager.has_plugin("time_limit")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        assert os.environ[var] == str(k)
    assert torch.get_num_threads() == k
    flags = os.environ["XLA_FLAGS"].split()
    assert flags.count("--xla_cpu_multi_thread_eigen=false") == 1
'''


def _run(tmp_path, source, plugin, args, env=None, where="tests",
         path=TESTS):
    """pytest on ``source``, written to ``tmp_path/where`` (``tests`` is
    the testpaths of the pyproject.toml it runs under), in a fresh process
    with ``plugin`` loaded from ``path``: (seconds, {test name: failure
    text or None}, the finished process)."""
    target = tmp_path / where / "test_target.py"
    target.parent.mkdir(exist_ok=True)
    target.write_text(source)
    xml = tmp_path / "report.xml"
    env = dict(os.environ if env is None else env, PYTHONPATH=path)
    for var in ("PYTEST_XDIST_WORKER", "PYTEST_XDIST_WORKER_COUNT",
                "PYTEST_XDIST_TESTRUNUID", "PYTEST_CURRENT_TEST"):
        env.pop(var, None)
    start = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider",
         "-p", plugin, "-c", PYPROJECT, "--rootdir", str(tmp_path),
         f"--junitxml={xml}", *args, str(target)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    seconds = time.monotonic() - start
    assert xml.exists(), proc.stdout[-3000:] + proc.stderr[-3000:]
    results = {}
    for case in ET.parse(xml).getroot().iter("testcase"):
        bad = case.find("failure")
        if bad is None:
            bad = case.find("error")
        results[case.get("name")] = (None if bad is None else
                                     bad.get("message", "") + (bad.text or ""))
    return seconds, results, proc


@pytest.mark.parametrize("xdist", [False, True], ids=["one_process", "n2"])
def test_a_test_past_its_limit_fails_alone(tmp_path, xdist):
    """A test that sleeps past its limit (the target sets it to 2 s)
    fails within seconds with a message naming the limit, and the next
    test still runs and passes, with xdist and without."""
    seconds, results, _ = _run(tmp_path, LIMITED, "time_limit",
                               ["-p", "xdist", "-n", "2"] if xdist else [])
    assert seconds < 30, seconds
    assert results.keys() == {"test_sleeps_past_its_limit", "test_passes"}
    assert "TimeLimitExceeded" in results["test_sleeps_past_its_limit"]
    assert "passed its time limit of 2 s" in results[
        "test_sleeps_past_its_limit"]
    assert results["test_passes"] is None


def test_tests_outside_testpaths_have_no_limit(tmp_path):
    """The limit holds only under testpaths: the same file outside it
    (as benchmark/tests is) runs its sleeping test to its end."""
    source = LIMITED.replace("time.sleep(60)", "time.sleep(4)")
    _, results, _ = _run(tmp_path, source, "time_limit", [], where=".")
    assert results == {"test_sleeps_past_its_limit": None,
                       "test_passes": None}


def test_a_hang_in_native_code_ends_its_worker(tmp_path):
    """A test that blocks SIGALRM, as one stuck in a native call would not
    see it, has its stack printed and its xdist worker ended a few seconds
    past its limit; it is reported as crashed and the next test passes."""
    source = LIMITED.replace("def test_sleeps_past_its_limit():",
                             "def test_hangs():\n"
                             "    signal.pthread_sigmask(signal.SIG_BLOCK, "
                             "[signal.SIGALRM])")
    seconds, results, proc = _run(tmp_path, source, "time_limit",
                                  ["-p", "xdist", "-n", "2"])
    assert seconds < 45, seconds
    assert results.keys() == {"test_hangs", "test_passes"}
    assert "crashed" in results["test_hangs"]
    assert "in test_hangs" in proc.stderr
    assert results["test_passes"] is None


def test_each_worker_gets_its_share_of_the_cpus(tmp_path):
    """The top-level conftest under ``-n 2`` with no thread variable set:
    each worker's OMP/MKL/OpenBLAS variables and torch's intra-op pool are
    sized to cpu_count // 2, XLA's Eigen flag, already in XLA_FLAGS when
    the run starts, is there once, and the time limit is loaded."""
    env = {k: v for k, v in os.environ.items() if k not in (
        "OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")}
    env["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false"
    _, results, proc = _run(tmp_path, SIZED, "conftest",
                            ["-p", "xdist", "-n", "2"], env=env, path=ROOT)
    assert results == {"test_worker_threads": None}, (results,
                                                      proc.stdout[-3000:])
