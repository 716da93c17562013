"""The port's one-command e2e run, held against the JAX package's.

Both packages run ``pipeline/e2e.run_reference_scale`` at the toy shape of
tests/test_workflow.py's e2e test (two datasets of 192 synthetic pairs,
the small ring grid, the f32 ``block`` sampler, a 1 x 2 PR grid whose mu
keeps the winner's diffs narrow, so the PJ stage stays cheap, and a 1 x 2
PJ grid), the port on the CPU (``device="cpu"``, so stage 1 takes
the numpy route, the JAX package's own on the CPU) with its draw functions
following the JAX key schedule: each sweep starts the key chain of its
own ``PRNGKey(seed)``, as each JAX sweep does, so the draws are keyed on
the sweep's generator.

Tolerances (those of tests/test_torch_pipeline.py and
tests/test_torch_pj_pipeline.py): the datasets bit for bit; the PR row's
and the PJ winners' FPR95 to 1e-5 (ROC areas of the same ordering); the
same ranked PR row, PJ winner and dims.
"""

import json
import os

import numpy as np
import pytest
from opencv_dlco_tpu.data.store import ArtifactStore as JaxStore
from opencv_dlco_tpu.pipeline.e2e import run_reference_scale as jax_run
from opencv_dlco_tpu.utils import configs as jcfg

import opencv_dlco_tpu_torch.models.pj_rda as port_pj
import opencv_dlco_tpu_torch.models.pr_rda as port_pr
from opencv_dlco_tpu_torch.data.store import ArtifactStore
from opencv_dlco_tpu_torch.pipeline.e2e import run_reference_scale
from opencv_dlco_tpu_torch.utils import configs as pcfg

from test_torch_rda import JaxDraws

DATASETS = {"tiny-a": 5, "tiny-b": 6}
N_PAIRS = 192
PR_SEED = pcfg.PRLearnConfig().seed
PJ_SEED = pcfg.PJLearnConfig().seed
FPR_TOL = 1e-5


def _kw(cfg, root):
    return dict(
        n_pairs=N_PAIRS, datasets=DATASETS, pr_iters=4000, pj_iters=40,
        pool_cfg=cfg.PoolRegionConfig(nr=6, nphi=2, nsigma=3),
        pr_overrides=dict(batch=128, log_step=2000, max_dim=10_000,
                          sampling="block", split_dtype="f32",
                          matmul_precision="highest"),
        pj_overrides=dict(log_step=20, batch=64),
        pr_grid=cfg.PRSweepGrid(mus=(0.2,), gammas=(0.05, 1.0)),
        pj_grid=cfg.PJSweepGrid(mus=(0.001,), gammas=(0.25, 0.5)),
        export_dims=(2048,),
        out_json=os.path.join(root, "E2E_FULL.json"),
        progress=False)


class _SweepDraws:
    """The port's draw functions on the JAX key schedule, one key chain
    per generator: each sweep (and each single run) makes its own
    generator, as each JAX one starts its own PRNGKey(seed)."""

    def __init__(self, seed):
        self.seed = seed
        self.chains = {}

    def _chain(self, gen):
        # the generator is kept alive by the dict, so its id stays unique
        return self.chains.setdefault(id(gen), (gen, JaxDraws(self.seed)))[1]

    def block_offsets(self, gen, *a):
        return self._chain(gen).block_offsets(gen, *a)

    def gather_rows(self, gen, *a):
        return self._chain(gen).gather_rows(gen, *a)

    def sweep_rows(self, gen, *a):
        return self._chain(gen).sweep_rows(gen, *a)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root_j = str(tmp_path_factory.mktemp("jax"))
    root_p = str(tmp_path_factory.mktemp("port"))
    out = {"jax": dict(root=root_j, res=jax_run(root_j, **_kw(jcfg, root_j)))}
    mp = pytest.MonkeyPatch()
    pr, pj = _SweepDraws(PR_SEED), _SweepDraws(PJ_SEED)
    mp.setattr(port_pr, "draw_block_offsets", pr.block_offsets)
    mp.setattr(port_pr, "draw_gather_rows", pr.gather_rows)
    mp.setattr(port_pj, "draw_sweep_rows", pj.sweep_rows)
    try:
        res = run_reference_scale(root_p, device="cpu", **_kw(pcfg, root_p))
    finally:
        mp.undo()
    out["port"] = dict(root=root_p, res=res, sweeps=(len(pr.chains),
                                                     len(pj.chains)))
    return out


def _keys(d):
    """Every key path of a nested dict (keys as strings, as in the JSON)."""
    out = set()
    for k, v in d.items():
        out.add(str(k))
        if isinstance(v, dict):
            out |= {f"{k}/{sub}" for sub in _keys(v)}
    return out


def test_datasets_are_bit_equal(runs):
    for name in DATASETS:
        rel = os.path.join("dataset", f"{name}.h5")
        with ArtifactStore(os.path.join(runs["port"]["root"], rel), "r") \
                as sp, JaxStore(os.path.join(runs["jax"]["root"], rel),
                                "r") as sj:
            for key in ("Indices", "Patches"):
                np.testing.assert_array_equal(sp.read(key), sj.read(key))
            assert sp.get_meta("generator") == sj.get_meta("generator")


def test_summary_has_the_same_keys_at_every_level(runs):
    rp, rj = runs["port"]["res"], runs["jax"]["res"]
    assert _keys(rp) == _keys(rj)
    assert rp["backend"] == "cpu" and rp["device"] == "cpu"
    for key in ("n_pairs", "n_rings", "n_filters", "datasets",
                "pj_datasets", "pr_grid_combos", "pj_grid_combos",
                "pr_iters_per_combo", "pj_iters_per_combo", "n_pj_models",
                "synthetic", "note"):
        assert rp[key] == rj[key], key
    # one key chain per dataset's PR sweep, one for the PJ sweep
    assert runs["port"]["sweeps"] == (len(DATASETS), 1)
    # the summary file is the returned dict
    with open(os.path.join(runs["port"]["root"], "E2E_FULL.json")) as fh:
        assert json.load(fh) == json.loads(json.dumps(rp))


def test_best_pr_row_and_pj_winners_agree(runs):
    rp, rj = runs["port"]["res"], runs["jax"]["res"]
    assert rp["pr_ref"] == rj["pr_ref"]
    bp, bj = rp["best_pr"], rj["best_pr"]
    assert (bp["row"], bp["dim"]) == (bj["row"], bj["dim"])
    assert bp["mean_fpr95"] == pytest.approx(bj["mean_fpr95"], abs=FPR_TOL)
    for ds in DATASETS:
        assert bp["per_dataset"][ds] == pytest.approx(
            bj["per_dataset"][ds], abs=FPR_TOL)
    assert sorted(rp["pj_winners"]) == sorted(rj["pj_winners"])
    for cap, wp in rp["pj_winners"].items():
        wj = rj["pj_winners"][cap]
        assert (wp["model"], wp["dim"]) == (wj["model"], wj["dim"])
        assert wp["mean_fpr95"] == pytest.approx(wj["mean_fpr95"],
                                                 abs=FPR_TOL)
        for ds in DATASETS:
            assert wp["per_dataset"][ds] == pytest.approx(
                wj["per_dataset"][ds], abs=FPR_TOL)


def test_exports_round_trip(runs):
    rp, rj = runs["port"]["res"], runs["jax"]["res"]
    assert sorted(rp["exports"]) == sorted(rj["exports"]) == [2048]
    for cap, ep in rp["exports"].items():
        ej = rj["exports"][cap]
        assert ep["ok"] and ej["ok"]
        assert (ep["n_pr"], ep["dim"], ep["pj_in"]) == \
            (ej["n_pr"], ej["dim"], ej["pj_in"])
        assert ep["pj_in"] == 8 * ep["n_pr"] and 0 < ep["dim"] <= cap
        assert os.path.basename(ep["path"]) == os.path.basename(ej["path"])
    for key in rj["stage_seconds"]:
        assert key in rp["stage_seconds"]


def test_card_description_names_the_power_limit(monkeypatch):
    """The summary's device: nvidia-smi's name and power limit line for
    the run's card, asked by its UUID, or the name and "power limit not
    read"."""
    import subprocess
    from types import SimpleNamespace

    import torch

    from opencv_dlco_tpu_torch.pipeline import e2e

    asked = []

    def smi(cmd, **kw):
        asked.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 0, stdout="NVIDIA H100 80GB HBM3, 500.00 W\n")

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "H100")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(uuid="5a1b-77"))
    monkeypatch.setattr(subprocess, "run", smi)
    dev = torch.device("cuda", 1)
    assert e2e.card_description(dev) == "NVIDIA H100 80GB HBM3, 500.00 W"
    assert asked == [["nvidia-smi", "-i", "GPU-5a1b-77",
                      "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]

    def fails(*a, **kw):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", fails)
    assert e2e.card_description(dev) == "H100, power limit not read"
