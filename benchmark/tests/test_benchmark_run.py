"""A whole run on the CPU at a toy size, untraced and traced, and the
runner's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import spec
from benchmark.harness.cell import run_cell
from benchmark.tests.conftest import toy

CELLS = [w["name"] for w in spec.benchmark_json()["workloads"]]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_run_cell_on_cpu(name, traced):
    result, info = run_cell(name, 2 ** 31 + 99, 0.0, traced, "cpu",
                            cell=toy(name))
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
    assert result["attempted"] > 0 and result["failed"] == 0
    cell = spec.cell(name, spec.benchmark_json())
    if traced:
        # the device's metrics are absent without a device trace
        names = {m["name"] for m in cell["per_layer"]}
        assert set(result["metrics"]) <= names
        assert not any("roofline" in k or "idle" in k
                       for k in result["metrics"])
    else:
        assert set(result["metrics"]) == {m["name"]
                                          for m in cell["end_to_end"]}
        assert all(m["value"] > 0 for m in result["metrics"].values())
    assert info["setup_s"] > 0 and info["window_s"] > 0
    json.dumps(result)


def test_runner_without_a_card_prints_no_result():
    """No card visible (hidden where there is one)."""
    proc = subprocess.run(
        [sys.executable, os.path.join(spec.BENCH_DIR, "run.py"),
         "--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=spec.ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_runner_without_the_program_fails(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark alone."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
