"""A time limit for each test, from the standard library alone.

Setup, call and teardown of every test under the project's ``testpaths``
(tests/, not benchmark/tests) each run under an interval timer (SIGALRM)
of ``DEFAULT_SECONDS``, read when the phase starts. When it fires, the
phase fails with ``TimeLimitExceeded`` and the run goes on with the next
test. The signal is delivered between Python bytecodes, so a test stuck
inside one native call is not interrupted by it: for that case
faulthandler prints every thread's stack ``HANG_GRACE_SECONDS`` after the
limit and ends the process (under xdist the controller reports the test
as crashed and starts another worker).

The checkout's top-level ``conftest.py`` registers it; another run loads
it with ``-p time_limit`` and this directory on ``PYTHONPATH``.
pytest-xdist runs tests in each worker's main thread, where SIGALRM is
handled.
"""

import contextlib
import faulthandler
import os
import signal

import pytest

DEFAULT_SECONDS = 600.0
HANG_GRACE_SECONDS = 5.0


class TimeLimitExceeded(Exception):
    pass


_stderr_key = pytest.StashKey[int]()


def pytest_configure(config):
    # a copy of the stderr descriptor as it is outside a test, where the
    # capture plugin has not redirected it: the stack of a hang is printed
    # there, not into a capture buffer that dies with the process
    config.stash[_stderr_key] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_stderr_key])


def _in_testpaths(item):
    config = item.config
    return any(item.path.is_relative_to(config.rootpath / p)
               for p in config.getini("testpaths"))


@contextlib.contextmanager
def _limited(item, when):
    if not _in_testpaths(item):
        yield
        return
    seconds = DEFAULT_SECONDS

    def expire(signum, frame):
        raise TimeLimitExceeded(
            f"{item.nodeid} ({when}) passed its time limit of {seconds:g} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    faulthandler.dump_traceback_later(seconds + HANG_GRACE_SECONDS,
                                      exit=True,
                                      file=item.config.stash[_stderr_key])
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _limited(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _limited(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _limited(item, "teardown"):
        return (yield)
