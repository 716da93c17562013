"""Gate on the port's committed run of the bench's precision suite,
``PRECISION_FPR95_torch.json``.

The file is the record of one run of

    python tools/precision_fpr95_run.py --out-json PRECISION_FPR95_torch.json

which is ``python -m opencv_dlco_tpu_torch.cli bench --suite precision``
(``bench_precision_fpr95`` at its defaults) on the card, beside the
card's nvidia-smi line. It is held to PARITY.md's gate on bf16 stage 3:
|dFPR95| (bf16 - f32) under 0.1 percentage points for the uniform and the
sparse ring weights, at 50,000 hard pairs with the full 40,960-filter
bank, the bf16 side through kernel A. The JAX package's committed record
(``bench_details.json["precision_fpr95"]``) is a TPU run: only its deltas
are comparable, not its times. This file fails, it does not skip, when
the run is missing.
"""

import json
import math
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_JSON = os.path.join(ROOT, "PRECISION_FPR95_torch.json")
#: PARITY.md's gate, percentage points of FPR95
DELTA_FPR95_GATE = 0.1
N_PAIRS = 50_000
N_FILTERS = 40_960
#: the suite's pair block
BLOCK = 512
# "<name>, <limit> W", as nvidia-smi --query-gpu=name,power.limit prints
CARD = re.compile(r"^\S.*, \d+(\.\d+)? W$")


@pytest.fixture(scope="module")
def rec():
    with open(PORT_JSON) as fh:        # missing file: the test fails
        return json.load(fh)


def test_ran_on_the_card_through_the_command(rec):
    assert CARD.match(rec["card"]), rec["card"]
    assert rec["command"] == ("python -m opencv_dlco_tpu_torch.cli bench "
                              "--suite precision")


def test_full_size_through_kernel_a(rec):
    got = rec["precision_fpr95"]
    assert got["n_pairs"] == N_PAIRS
    assert got["n_filters"] == N_FILTERS
    assert got["bf16_route"] == "kernel_A"
    blocks = -(-N_PAIRS // BLOCK)
    assert got["kernel_a_launches"] == blocks
    assert rec["kernel_a_launches"] == blocks


@pytest.mark.parametrize("w", ["uniform", "sparse"])
def test_delta_fpr95_is_under_the_gate(rec, w):
    got = rec["precision_fpr95"]
    delta = got[f"delta_fpr95_{w}"]
    assert math.isfinite(delta) and abs(delta) < DELTA_FPR95_GATE
    assert delta == pytest.approx(got[f"bf16_{w}_fpr95"]
                                  - got[f"f32_{w}_fpr95"])
    assert got["bf16_safe"]
