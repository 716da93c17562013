"""Gate on the port's committed runs of the ``e2e`` command on the
bf16-opted stage-3 route (kernel A): ``E2E_FULL_bf16_torch.json`` and
``E2E_M50_bf16_torch.json``.

Each is the summary of one uninterrupted run of

    python tools/e2e_memory_run.py -w <empty workspace> \\
        --matmul-precision default --out-json <summary> --mem-json <memory> \\
        [--n-pairs 100000 --pj-iters 10000]

on the card, its memory JSON committed beside it (``*.memory.json``:
the kernel launches, the stage-3 calls of each route, each stage's
seconds and peaks). The 100k run ran twice; the second summary is
``E2E_FULL_bf16_torch.run2.json``. Each run is held to its f32 twin on
the same card and seeds, ``E2E_FULL_torch.json`` and
``E2E_M50_torch.json``: stage 1 is deterministic on the card, so the
pairs are the same and only stage 3's route differs. The tolerances are
those of tests/test_torch_e2e_artifact.py. This file fails, it does not
skip, when a run is missing.
"""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: bf16 run -> its f32 twin
RUNS = {"E2E_FULL_bf16_torch.json": "E2E_FULL_torch.json",
        "E2E_M50_bf16_torch.json": "E2E_M50_torch.json"}
#: |bf16 - f32| of the best PR row's mean FPR95
BEST_PR_FPR95_TOL = 0.005
#: |bf16 - f32| of each PJ cap winner's mean FPR95
PJ_FPR95_TOL = 0.010
EXPORT_CAPS = ("48", "64", "80", "120")
#: run_reference_scale's Workspace(pair_block)
PAIR_BLOCK = 8192
#: kernel B launches once a PR log period: 508 a dataset
B_LAUNCHES = 1524
SHAPE_FIELDS = ("n_pairs", "n_rings", "n_filters", "datasets",
                "pj_datasets", "pr_grid_combos", "pr_iters_per_combo",
                "pj_grid_combos", "pj_iters_per_combo", "n_pj_models",
                "synthetic", "backend")
# "<name>, <limit> W", as nvidia-smi --query-gpu=name,power.limit prints
CARD = re.compile(r"^\S.*, \d+(\.\d+)? W$")


def _load(name):
    with open(os.path.join(ROOT, name)) as fh:   # missing: the test fails
        return json.load(fh)


@pytest.fixture(params=sorted(RUNS), scope="module")
def run(request):
    name = request.param
    return dict(bf16=_load(name), f32=_load(RUNS[name]),
                mem=_load(name.replace(".json", ".memory.json")))


def test_same_shape_and_card_as_the_f32_twin(run):
    for key in SHAPE_FIELDS:
        assert run["bf16"][key] == run["f32"][key], key
    assert set(run["bf16"]) == set(run["f32"]) | {"matmul_precision",
                                                   "stage3_route"}
    assert run["bf16"]["backend"] == "cuda"
    assert CARD.match(run["bf16"]["device"]), run["bf16"]["device"]
    # the same card model (its power limit is printed beside it)
    assert run["bf16"]["device"].split(",")[0] == \
        run["f32"]["device"].split(",")[0]
    assert CARD.match(run["mem"]["card"]), run["mem"]["card"]


def test_stage3_took_kernel_a_once_a_block(run):
    bf16, mem = run["bf16"], run["mem"]
    for rec in (bf16, mem):
        assert rec["matmul_precision"] == "default"
        assert rec["stage3_route"] == "kernel_A"
    blocks = len(bf16["datasets"]) * -(-bf16["n_pairs"] // PAIR_BLOCK)
    assert mem["stage3_calls"] == {"kernel_A": blocks, "f32": 0}
    assert mem["launches"]["A"] == blocks
    assert mem["launches"]["B"] == B_LAUNCHES


def test_best_pr_row_is_within_tolerance_of_the_f32_twin(run):
    got, want = run["bf16"]["best_pr"], run["f32"]["best_pr"]
    assert set(got["per_dataset"]) == set(run["bf16"]["datasets"])
    assert abs(got["mean_fpr95"] - want["mean_fpr95"]) <= BEST_PR_FPR95_TOL
    assert 0 < got["dim"] <= 640


def test_pj_winners_are_within_tolerance_of_the_f32_twin(run):
    got, want = run["bf16"]["pj_winners"], run["f32"]["pj_winners"]
    assert sorted(got) == sorted(want) == sorted(EXPORT_CAPS)
    for cap in EXPORT_CAPS:
        assert abs(got[cap]["mean_fpr95"] - want[cap]["mean_fpr95"]) \
            <= PJ_FPR95_TOL, cap
        assert 0 < got[cap]["dim"] <= int(cap)


def test_four_exports_round_trip(run):
    exports = run["bf16"]["exports"]
    assert sorted(exports) == sorted(EXPORT_CAPS)
    for cap, rec in exports.items():
        assert rec["ok"], cap
        assert 0 < rec["dim"] <= int(cap)
        assert rec["pj_in"] == 8 * rec["n_pr"]
        assert rec["dim"] == run["bf16"]["pj_winners"][cap]["dim"]


def test_every_stage_is_timed_with_its_peaks(run):
    times, stages = run["bf16"]["stage_seconds"], run["mem"]["stages"]
    assert set(times) == set(run["f32"]["stage_seconds"]) == set(stages)
    for key, rec in stages.items():
        assert times[key] > 0 and rec["seconds"] > 0, key
        assert rec["host_rss_peak_bytes"] > 0, key
    for ds in run["bf16"]["datasets"]:
        assert stages[f"03_compdist[{ds}]"]["device_peak_bytes"] > 0, ds


def _no_seconds(d):
    """The summary without its wall-clock fields."""
    out = {}
    for k, v in d.items():
        if k in ("stage_seconds", "total_wall_seconds"):
            continue
        out[k] = _no_seconds(v) if isinstance(v, dict) else v
    return out


def test_the_two_100k_runs_agree_but_seconds():
    one = _load("E2E_FULL_bf16_torch.json")
    two = _load("E2E_FULL_bf16_torch.run2.json")
    assert _no_seconds(one) == _no_seconds(two)
    assert set(one["stage_seconds"]) == set(two["stage_seconds"])
