"""On the card: each cell at a size a test run holds, the program held to
its limits, and the control (the plain reference in TF32 in the
program's place) failing them; in the PJ cells, the Newton-Schulz
products alone in TF32 or bfloat16 failing them too. Skips without a
card.

    python3 -m pytest benchmark/tests/test_benchmark_card.py -m cuda -q
"""

import pytest

from benchmark.harness import spec
from benchmark.harness.cell import run_cell
from benchmark.tests.conftest import toy
from benchmark.tools.faults import PRECISION

pytestmark = pytest.mark.cuda

# the toy bank at the published patch size, full 8,192-pair blocks cut to
# 512, the PJ grid whole at the cell's width on smaller splits
SIZES = {"stage3": dict(n_pairs=4096, unique_pairs=2048, draw_chunk=1024,
                        sample_pairs=512),
         "pj_sweep": dict(n_trn=20000, n_val=5000)}


def _cell(name):
    cell = spec.cell(name, spec.benchmark_json())
    c = toy(name, **SIZES[cell["traffic"]["entry"]])
    if cell["traffic"]["entry"] == "stage3":
        c["config"].update(pair_block=512)
    else:
        c["config"]["pj"] = dict(cell["config"]["pj"], log_step=1)
        c["config"]["pj_n_feat"] = cell["config"]["pj_n_feat"]
    return c


@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark_json()["workloads"]])
def test_program_correct_and_control_not(cuda_card, name):
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        result, info = run_cell(name, seed, 0.0, False, "cuda",
                                cell=_cell(name), control=True)
        assert result["correct"] is True, info["numbers"]
        limits = spec.cell(name, spec.benchmark_json())["limits"]["compare"]
        assert any(info["control"][k] > v["limit"]
                   for k, v in limits.items()), info["control"]


PJ_CELLS = [w["name"] for w in spec.benchmark_json()["workloads"]
            if spec.cell(w["name"], spec.benchmark_json())["traffic"]["entry"]
            == "pj_sweep"]


@pytest.mark.parametrize("path", sorted(PRECISION["pj_sweep"]))
@pytest.mark.parametrize("name", PJ_CELLS)
def test_lower_precision_newton_schulz_not_correct(cuda_card, name, path):
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        with PRECISION["pj_sweep"][path]():
            result, info = run_cell(name, seed, 0.0, False, "cuda",
                                    cell=_cell(name))
        assert result["correct"] is False, info["numbers"]
