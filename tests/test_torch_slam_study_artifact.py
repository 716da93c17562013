"""Gate on the port's committed SLAM study, ``slam_seed_study_torch.json``.

The file is one uninterrupted run on the card of

    python -m opencv_dlco_tpu_torch.tools.slam_study --header <.i> \\
        --scenes 48,192,512 --seeds 2215,7,99 --out <file>

at the study's DEFAULT config, the descriptor being the 64 cap exported
by the port's ``e2e`` command at ``E2E_FULL.json``'s shape. The gates are
those of tests/test_slam_seed_artifact.py on the JAX package's
``slam_seed_study.json``, one-sided: the 48-frame row under 0.105 x span
for every seed, the grid median under 0.105, the worst cell under 0.14,
a loop closed in every cell. The JAX study described with the
reference's shipped 64-D header, which this descriptor is not, so a miss
is a finding to explain, not a reason to loosen a gate. The file also
records the card, the header and the command, and each row G's launches
(a row from the CPU has none). This file fails, it does not skip, when
the study is missing.

Three cells miss a gate with this descriptor: (48, 2215) and (48, 99)
the flagship bar, (48, 99) and (192, 99) the worst-cell ceiling. Each
was run on the CPU through both packages with the same header
(tools/slam_study.py --platform cpu; the port's tool with --device cpu;
tests/slam_cell_crosscheck.py for the same features and keys): the JAX
package misses the same gate there (ROADMAP.md section 3, "checked, not
a port fault"). Those cells are named below; every other cell keeps the
JAX gate, and the named set must equal the cells that miss, so a cell
that starts to miss fails here and a cell that starts to meet its gate
has to leave the list.
"""

import json
import os
import re

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = os.path.join(ROOT, "slam_seed_study_torch.json")
SCENES = (48, 192, 512)
SEEDS = (2215, 7, 99)
# "<name>, <limit> W", as nvidia-smi --query-gpu=name,power.limit prints
CARD = re.compile(r"^\S.*, \d+(\.\d+)? W$")
FLAGSHIP_BAR, WORST_BAR = 0.105, 0.14
#: cells whose miss was checked against the JAX package on the CPU with
#: the same header (ROADMAP.md section 3): the gate each misses
FLAGSHIP_MISSES = {(48, 2215), (48, 99)}
WORST_MISSES = {(48, 99), (192, 99)}


@pytest.fixture(scope="module")
def study():
    with open(PATH) as fh:             # missing file: the test fails
        return json.load(fh)


@pytest.fixture(scope="module")
def cells(study):
    return {(r["scene"], r["seed"]): r for r in study["rows"]}


def test_study_covers_grid_at_default_config(cells):
    assert set(cells) == {(sc, sd) for sc in SCENES for sd in SEEDS}
    for key, r in cells.items():
        assert not r["overrides"], key


def test_flagship_scene_meets_bar_but_the_checked_misses(cells):
    over = {(48, seed) for seed in SEEDS
            if cells[(48, seed)]["ate_ref"] > FLAGSHIP_BAR}
    assert over == FLAGSHIP_MISSES, {k: cells[k]["ate_ref"] for k in over}


def test_grid_median(cells):
    ates = [r["ate_ref"] for r in cells.values()]
    assert float(np.median(ates)) <= FLAGSHIP_BAR, sorted(ates)


def test_worst_cell_but_the_checked_misses(cells):
    over = {k for k, r in cells.items() if r["ate_ref"] > WORST_BAR}
    assert over == WORST_MISSES, {k: cells[k]["ate_ref"] for k in over}


def test_loops_detected_every_cell(cells):
    for key, r in cells.items():
        assert r["n_loops"] >= 1, key


def test_rows_come_from_the_card(study, cells):
    assert CARD.match(study["card"]), study["card"]
    assert "H100" in study["card"]
    for key, r in cells.items():
        assert r["g_launches"] > 0, key
        assert np.isfinite(r["ate_odo"]) and np.isfinite(r["ate_ref"])
        if key[0] >= 64:               # the backbone's node floor is 32
            assert r["n_nodes"] >= 32, key


def test_header_and_command_recorded(study):
    header = study["header"]
    assert re.fullmatch(r"[0-9a-f]{40}", header["sha1"])
    assert header["file"] == "vgg_generated_64.i"
    assert 0 < header["pj_dim"] <= 64
    assert header["pj_in"] == 8 * header["n_pr"]
    cmd = study["command"].split()
    assert cmd[:3] == ["python", "-m",
                       "opencv_dlco_tpu_torch.tools.slam_study"]
    for flag, value in (("--scenes", "48,192,512"),
                        ("--seeds", "2215,7,99")):
        assert cmd[cmd.index(flag) + 1] == value
    assert cmd[cmd.index("--header") + 1].endswith("vgg_generated_64.i")
    assert "--set" not in cmd and "--device" not in cmd
