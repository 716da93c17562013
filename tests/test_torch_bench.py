"""The port's bench (``opencv_dlco_tpu_torch/bench.py``) and its timing
tools (``utils/profiling.py``) on the CPU at toy sizes.

Each suite's result keys are held against the JAX package's suite at the
same sizes, modulo the renames the port's bench docstring lists (a TPU
unit's name becomes the card's: ``pallas_time`` -> ``kernel_time``,
``*_mxu_floor`` -> ``*_tc_floor``). On the CPU both packages skip their
kernel routes, so the key sets are equal. The values are timings and are
only checked to be finite and positive.
"""

import json
import math
import os

import pytest
import torch

from opencv_dlco_tpu import bench as jax_bench

from opencv_dlco_tpu_torch import bench
from opencv_dlco_tpu_torch.cli import main as cli_main
from opencv_dlco_tpu_torch.utils.profiling import StageTimer, device_trace

RENAMES = {"pallas_time": "kernel_time"}


def _port_name(key):
    if key.endswith("_mxu_floor"):
        return key[:-len("_mxu_floor")] + "_tc_floor"
    return RENAMES.get(key, key)


SUITES = {
    "hinge": ("bench_hinge_kernels", dict(n=1000)),
    "pr_validate": ("bench_pr_validate", dict(n_feat=64, n_pos=300,
                                              n_neg=200)),
    "pr_rda": ("bench_pr_rda", dict(n_feat=64, n_rows=600, batch=128,
                                    steps=2)),
}


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_suite_keys_match_jax(suite):
    name, kw = SUITES[suite]
    ours = getattr(bench, name)(device="cpu", **kw)
    ref = getattr(jax_bench, name)(**kw)
    assert set(ours) == {_port_name(k) for k in ref}
    for k, v in ours.items():
        if k.endswith(("_time", "_per_sec", "vs_baseline")):
            assert math.isfinite(v) and v > 0, (k, v)


def test_every_jax_suite_has_a_port():
    names = {n for n in dir(jax_bench)
             if n.startswith("bench_") or n in ("_fetch", "_timeit", "run")}
    assert names and all(callable(getattr(bench, n, None)) for n in names)


def test_run_hinge_writes_details_and_headline(tmp_path, capsys):
    out = tmp_path / "details.json"
    bench.run(suite="hinge", out_path=str(out), device="cpu")
    details = json.loads(out.read_text())
    assert details["backend"] == "cpu"
    assert details["hinge"]["sorted_time"] > 0
    assert "kernel_time" not in details["hinge"]  # the kernel is card-only
    last = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(last)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}


def test_cli_bench_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "cli.json"
    cli_main(["bench", "--suite", "hinge", "--out", str(out),
              "--device", "cpu"])
    assert "sorted_time" in json.loads(out.read_text())["hinge"]
    json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_default_out_path_is_the_ports_own():
    import inspect

    default = inspect.signature(bench.run).parameters["out_path"].default
    assert default == bench.DEFAULT_OUT == "bench_details_torch.json"
    assert os.path.basename(default) != "bench_details.json"


def test_run_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run(suite="hinge", out_path=os.devnull)


def test_timeit_is_the_mean_after_warmup():
    calls = []
    dt = bench._timeit(lambda: calls.append(1) or torch.zeros(1),
                       warmup=3, iters=5)
    assert len(calls) == 8 and dt >= 0.0


def test_stage_timer_accumulates_totals_and_counts():
    timer = StageTimer()
    for _ in range(3):
        with timer.time("a", sync_on=(torch.ones(2), {"x": torch.zeros(1)})):
            pass
    with timer.time("b"):
        pass
    assert timer.counts == {"a": 3, "b": 1}
    assert timer.totals["a"] >= 0.0 and set(timer.totals) == {"a", "b"}
    assert "a: total" in timer.report() and "n=3" in timer.report()


def test_device_trace_is_a_noop_without_a_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("DLCO_TRACE_DIR", raising=False)
    with device_trace() as where:
        assert where is None
    trace_dir = tmp_path / "trace"
    with device_trace(str(trace_dir)) as where:
        torch.ones(4).sum()
    assert where == str(trace_dir) and any(trace_dir.iterdir())


def test_slam_suites_skip_without_a_header(tmp_path):
    out = tmp_path / "slam.json"
    for suite in ("slam", "slam_long", "slam_xl"):
        details = bench.run(suite=suite, out_path=str(out), device="cpu")
        assert set(details[suite]) == {"skipped"}, details[suite]


def test_slam_suites_pass_the_header_through(monkeypatch, tmp_path, capsys):
    """run() and ``cli bench --header`` hand the header to bench_slam at
    each suite's length (a stub stands in for the SLAM run)."""
    calls = []

    def bench_slam(n_frames=48, size=256, n_keypoints=256, header=None,
                   device="cuda"):
        calls.append((n_frames, header, torch.device(device).type))
        return {"n_frames": n_frames}

    monkeypatch.setattr(bench, "bench_slam", bench_slam)
    out = tmp_path / "slam.json"
    for suite in ("slam", "slam_long", "slam_xl"):
        details = bench.run(suite=suite, out_path=str(out), device="cpu",
                            header="h.i")
        assert details[suite] == {"n_frames": calls[-1][0]}
    cli_main(["bench", "--suite", "slam_xl", "--header", "m.i", "--out",
              str(out), "--device", "cpu"])
    assert calls == [(48, "h.i", "cpu"), (192, "h.i", "cpu"),
                     (512, "h.i", "cpu"), (512, "m.i", "cpu")]
    assert json.loads(out.read_text())["slam_xl"] == {"n_frames": 512}
    json.loads(capsys.readouterr().out.strip().splitlines()[-1])
