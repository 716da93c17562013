"""Gate on the port's committed run of the ``e2e`` command at its defaults,
``E2E_M50_torch.json``.

The file is the summary of one uninterrupted run of

    python -m opencv_dlco_tpu_torch.cli e2e -w <empty workspace> \\
        --out-json E2E_M50_torch.json

on the card: m50_500000, the reference's published pair-set scale (3
synthetic datasets of 500,000 pairs), 50M samples a PR combo and 50,000
iterations a PJ combo. No run of the JAX package exists at this shape,
so the gates are one-sided against ``E2E_FULL.json``, its run at 100,000
pairs and 10,000 PJ iterations: five times the pairs (and, for the PJ
grid, five times the iterations) is not expected to make a metric worse.
The tolerances are those of tests/test_torch_e2e_artifact.py. This file
fails, it does not skip, when the run is missing.
"""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_JSON = os.path.join(ROOT, "E2E_M50_torch.json")
REF_JSON = os.path.join(ROOT, "E2E_FULL.json")

#: the best PR row's mean FPR95 may exceed the reference's by at most this
BEST_PR_FPR95_TOL = 0.005
#: the reference's MaxDim gate on the PR row (04-prlearn.sh)
BEST_PR_MAX_DIM = 640
#: the PJ winners' mean FPR95 may exceed the reference's by at most this,
#: at these caps
PJ_FPR95_TOL = 0.010
PJ_HELD_CAPS = ("48", "64")
#: caps whose winner is ranked over a superset of the 64 cap's models
PJ_SUPERSET_CAPS = ("80", "120")
EXPORT_CAPS = ("48", "64", "80", "120")
#: the CLI's defaults (cli.py, the ``e2e`` parser and run_reference_scale)
SHAPE = {"n_pairs": 500_000, "pr_iters_per_combo": 50_000_000,
         "pj_iters_per_combo": 50_000, "n_rings": 5120,
         "n_filters": 40960, "pr_grid_combos": 256, "pj_grid_combos": 45,
         "n_pj_models": 45, "datasets": ["synlib", "synnot", "synyos"],
         "pj_datasets": ["synlib"], "synthetic": True}
# "<name>, <limit> W", as nvidia-smi --query-gpu=name,power.limit prints
CARD = re.compile(r"^\S.*, \d+(\.\d+)? W$")


@pytest.fixture(scope="module")
def port():
    with open(PORT_JSON) as fh:        # missing file: the test fails
        return json.load(fh)


@pytest.fixture(scope="module")
def ref():
    with open(REF_JSON) as fh:
        return json.load(fh)


def test_shape_fields_are_the_cli_defaults(port, ref):
    assert {k: port[k] for k in SHAPE} == SHAPE
    assert set(port) == set(ref)


def test_ran_on_the_card(port):
    assert port["backend"] == "cuda"
    assert CARD.match(port["device"]), port["device"]


def test_best_pr_row_is_no_worse_than_the_reference(port, ref):
    got, want = port["best_pr"], ref["best_pr"]
    assert set(got["per_dataset"]) == set(port["datasets"])
    assert got["mean_fpr95"] <= want["mean_fpr95"] + BEST_PR_FPR95_TOL
    assert 0 < got["dim"] <= BEST_PR_MAX_DIM


def test_pj_winners_are_no_worse_than_the_reference(port, ref):
    got, want = port["pj_winners"], ref["pj_winners"]
    assert sorted(got) == sorted(EXPORT_CAPS)
    for cap in PJ_HELD_CAPS:
        assert got[cap]["mean_fpr95"] <= want[cap]["mean_fpr95"] \
            + PJ_FPR95_TOL, cap
    for cap in EXPORT_CAPS:
        assert set(got[cap]["per_dataset"]) == set(port["datasets"])
        assert 0 < got[cap]["dim"] <= int(cap)
    for cap in PJ_SUPERSET_CAPS:
        assert got[cap]["mean_fpr95"] <= got["64"]["mean_fpr95"], cap


def test_exports_are_ok_within_their_caps(port):
    exports = port["exports"]
    assert sorted(exports) == sorted(EXPORT_CAPS)
    for cap, rec in exports.items():
        assert rec["ok"], cap
        assert rec["n_pr"] >= 1, cap
        assert 0 < rec["dim"] <= int(cap)
        assert rec["pj_in"] == 8 * rec["n_pr"]
        assert rec["dim"] == port["pj_winners"][cap]["dim"]


def test_every_stage_has_a_positive_time(port, ref):
    times = port["stage_seconds"]
    assert set(times) == set(ref["stage_seconds"])
    for ds in port["datasets"]:
        for fam in ("01_generate", "03_compdist", "04_prsweep",
                    "07_compunproj"):
            assert times[f"{fam}[{ds}]"] > 0, f"{fam}[{ds}]"
    for key in ("02_genpr", "05_prstats", "09_pjstats"):
        assert times[key] > 0, key
    for ds in port["pj_datasets"]:
        assert times[f"08_pjsweep[{ds}]"] > 0, ds
    for cap in EXPORT_CAPS:
        assert times[f"11_export[{cap}]"] > 0, cap
    assert port["total_wall_seconds"] > 0
