"""Shared pieces of the benchmark's tests: cells cut to a CPU-sized toy
(the same files, smaller sizes) and the card fixture."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import spec  # noqa: E402


def toy(name: str, **traffic) -> dict:
    """The cell ``name`` as BENCHMARK.json has it, cut to a toy: a bank
    of 16 rings, 16-pair blocks; a 2 x 3 PJ grid at F = 16."""
    cell = copy.deepcopy(spec.cell(name, spec.benchmark_json()))
    cfg = cell["config"]
    cfg["pool_regions"].update(nr=4, nphi=2, nsigma=2)
    cfg.update(n_rings=16, n_filters=128, pair_block=16, pj_n_feat=16)
    cfg["pj"]["mus"] = cfg["pj"]["mus"][:2]
    cfg["pj"]["gammas"] = cfg["pj"]["gammas"][:3]
    cfg["pj"].update(batch=8, log_step=5)
    tr = cell["traffic"]
    if tr["entry"] == "stage3":
        tr.update(n_pairs=128, unique_pairs=32, draw_chunk=32,
                  sample_pairs=32)
    else:
        tr.update(n_trn=96, n_val=40)
    tr.update(traffic)
    return cell


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
