"""Gate on the port's committed full-scale e2e run, ``E2E_FULL_torch.json``.

The file is the summary of one run of

    python -m opencv_dlco_tpu_torch.cli e2e -w <ws> --n-pairs 100000 \\
        --pj-iters 10000 --out-json E2E_FULL_torch.json

on the card. It is held to ``E2E_FULL.json``, the JAX package's run at the
same shape: the same shape fields, and metric parity within the tolerances
below. The port draws its datasets on the card with torch's generator, so
they match the JAX run's only in distribution, and so do the sampling
streams; the tolerances are set from the spread across datasets inside
``E2E_FULL.json`` (0.27 pp for the best PR row, 1.2-1.5 pp for the PJ
winners). Unlike tests/test_e2e_artifact.py this file fails, it does not
skip, when the port's run is missing.
"""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_JSON = os.path.join(ROOT, "E2E_FULL_torch.json")
REF_JSON = os.path.join(ROOT, "E2E_FULL.json")

#: |port - reference| of the best PR row's mean FPR95
BEST_PR_FPR95_TOL = 0.005
#: the reference's MaxDim gate on the PR row (04-prlearn.sh)
BEST_PR_MAX_DIM = 640
#: |port - reference| of the PJ winners' mean FPR95, at these caps
PJ_FPR95_TOL = 0.010
PJ_HELD_CAPS = ("48", "64")
#: caps whose winner is ranked over a superset of the 64 cap's models
PJ_SUPERSET_CAPS = ("80", "120")
EXPORT_CAPS = ("48", "64", "80", "120")
SHAPE_FIELDS = ("n_pairs", "n_rings", "n_filters", "datasets",
                "pj_datasets", "pr_grid_combos", "pr_iters_per_combo",
                "pj_grid_combos", "pj_iters_per_combo", "n_pj_models",
                "synthetic")
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


def test_shape_fields_equal_the_reference_run(port, ref):
    for key in SHAPE_FIELDS:
        assert port[key] == ref[key], key
    assert port["n_pairs"] == 100_000
    assert port["pr_grid_combos"] == 256
    assert port["pr_iters_per_combo"] == 50_000_000
    assert port["pj_grid_combos"] == 45
    assert port["pj_iters_per_combo"] == 10_000
    assert set(port) == set(ref)


def test_ran_on_the_card(port):
    assert port["backend"] == "cuda"
    assert CARD.match(port["device"]), port["device"]


def test_best_pr_row_is_within_tolerance(port, ref):
    got, want = port["best_pr"], ref["best_pr"]
    assert set(got["per_dataset"]) == set(port["datasets"])
    assert abs(got["mean_fpr95"] - want["mean_fpr95"]) <= BEST_PR_FPR95_TOL
    assert 0 < got["dim"] <= BEST_PR_MAX_DIM


def test_pj_winners_are_within_tolerance(port, ref):
    got, want = port["pj_winners"], ref["pj_winners"]
    assert sorted(got) == sorted(EXPORT_CAPS)
    for cap in PJ_HELD_CAPS:
        assert abs(got[cap]["mean_fpr95"] - want[cap]["mean_fpr95"]) \
            <= PJ_FPR95_TOL, cap
    for cap in EXPORT_CAPS:
        assert set(got[cap]["per_dataset"]) == set(port["datasets"])
        assert 0 < got[cap]["dim"] <= int(cap)
    # pj_rank_cross ranks a superset of models as the cap grows
    for cap in PJ_SUPERSET_CAPS:
        assert got[cap]["mean_fpr95"] <= got["64"]["mean_fpr95"], cap


def test_exports_are_ok_within_their_caps(port):
    exports = port["exports"]
    assert sorted(exports) == sorted(EXPORT_CAPS)
    for cap, rec in exports.items():
        assert rec["ok"], cap
        assert 0 < rec["dim"] <= int(cap)
        assert rec["pj_in"] == 8 * rec["n_pr"]
        assert rec["dim"] == port["pj_winners"][cap]["dim"]


def test_every_stage_is_timed(port):
    times = port["stage_seconds"]
    for ds in port["datasets"]:
        for fam in ("01_generate", "03_compdist", "04_prsweep",
                    "07_compunproj"):
            assert times.get(f"{fam}[{ds}]", 0) > 0, f"{fam}[{ds}]"
    for key in ("02_genpr", "05_prstats", "09_pjstats"):
        assert times.get(key, 0) > 0, key
    for ds in port["pj_datasets"]:
        assert times.get(f"08_pjsweep[{ds}]", 0) > 0, ds
    for cap in EXPORT_CAPS:
        assert f"11_export[{cap}]" in times, cap
    assert port["total_wall_seconds"] > 0
