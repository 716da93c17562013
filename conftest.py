"""pytest set-up for the whole checkout, loaded before tests/conftest.py.

Under pytest-xdist each of the N workers would size torch's intra-op pool
and XLA's Eigen pool to the whole host, N times over, and the tier-1 run
thrashed about 5x oversubscribed CPUs. So each worker gets its share of
the CPUs: OMP/MKL/OpenBLAS threads of cpu_count // N where unset (torch
sizes its pool from OMP_NUM_THREADS when it starts) and XLA's Eigen pool
off. Only workers do this: the controller's environment is inherited by
the workers it starts, and a single-process run keeps the libraries'
defaults and whatever the caller set. It must run before the first jax
or torch import, which is why it lives here and not in tests/.

It also registers the per-test time limit, tests/time_limit.py.
"""

import importlib.util
import os

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)
EIGEN_OFF = "--xla_cpu_multi_thread_eigen=false"
if WORKERS > 1:
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, str(THREADS))
    flags = os.environ.get("XLA_FLAGS", "").split()
    if EIGEN_OFF not in flags:
        os.environ["XLA_FLAGS"] = " ".join(flags + [EIGEN_OFF])


def pytest_configure(config):
    # loaded by its path: a tests/ put on sys.path here would reach the
    # xdist workers ahead of this directory, where "conftest" would then
    # name tests/conftest.py
    spec = importlib.util.spec_from_file_location("time_limit", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "time_limit.py"))
    time_limit = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(time_limit)
    config.pluginmanager.register(time_limit, "time_limit")
