"""The measurement tools around the ``e2e`` command, on the CPU at the toy
shape of tests/test_torch_e2e.py: ``tools/e2e_memory_run.py``'s stage
wrappers, ``tools/compdist_profile.py``'s parts and
``tools/npy_read_peak.py``'s per-tree reads. They measure on the card;
here they run the plain path, to show that they time every stage of
``run_full``, leave the package as they found it, and that the profile's
parts compute the stage's own rows.
"""

import importlib.util
import json
import os

import pytest
import torch

from opencv_dlco_tpu_torch.data.store import ArtifactStore
from opencv_dlco_tpu_torch.parallel import sweep
from opencv_dlco_tpu_torch.pipeline import e2e, stages
from opencv_dlco_tpu_torch.pipeline.e2e import run_reference_scale
from opencv_dlco_tpu_torch.utils import configs as pcfg

from test_torch_e2e import DATASETS, _kw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def toy_run(tmp_path_factory):
    """run_reference_scale at the toy shape under e2e_memory_run's stage
    wrappers (the card's calls made no-ops: the run is on the CPU)."""
    tool = _tool("e2e_memory_run")
    root = str(tmp_path_factory.mktemp("e2e_tools"))
    inner = {name: getattr(owner, name) for owner, name in (
        (e2e, "generate_synthetic_dataset"), (sweep, "run_pr_sweep"),
        (sweep, "run_pj_sweep"), (stages.Workspace, "compdist"))}
    records = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("synchronize", "reset_peak_memory_stats"):
            mp.setattr(torch.cuda, name, lambda *a, **kw: None)
        for name in ("max_memory_allocated", "max_memory_reserved"):
            mp.setattr(torch.cuda, name, lambda *a, **kw: 0)
        sampler = tool.Sampler(0.05)
        sampler.start()
        restore = tool.install(sampler, records)
        try:
            res = run_reference_scale(root, device="cpu",
                                      **_kw(pcfg, root))
        finally:
            restore()
            sampler.stop()
    restored = {name: getattr(owner, name) for owner, name in (
        (e2e, "generate_synthetic_dataset"), (sweep, "run_pr_sweep"),
        (sweep, "run_pj_sweep"), (stages.Workspace, "compdist"))}
    return dict(root=root, res=res, records=records, inner=inner,
                restored=restored)


def test_memory_run_records_every_stage_of_the_run(toy_run):
    records, stage_seconds = toy_run["records"], toy_run["res"][
        "stage_seconds"]
    assert set(records) == set(stage_seconds)
    for key, rec in records.items():
        # run_full's own timing of the stage (rounded to 1 ms) encloses
        # the wrapper's clock
        assert 0 < rec["seconds"] <= stage_seconds[key] + 1e-3, key
        assert rec["host_rss_peak_bytes"] > 0, key
    assert toy_run["restored"] == toy_run["inner"]


def test_compdist_profile_parts_compute_the_stage_rows(toy_run, tmp_path):
    tool = _tool("compdist_profile")
    out = tmp_path / "profile.json"
    tool.main(["-w", toy_run["root"], "--ds", min(DATASETS),
               "--blocks", "2", "--pair-block", "64", "--device", "cpu",
               "--out-json", str(out)])
    got = json.loads(out.read_text())
    for part in ("split", "program", "profiled"):
        assert got[part]["rows_equal_stage_output"], part
    assert set(got["split"]["seconds_total"]) == set(tool.PARTS)
    assert all(len(v) == 2 for v in got["split"]["seconds_per_block"]
               .values())
    assert got["profiled"]["device_busy_share"] == "not measured"
    assert not [p for p in os.listdir(os.path.join(toy_run["root"],
                                                   "distances"))
                if p.startswith("_profile_")]


def test_npy_read_peak_reads_through_each_tree(toy_run, tmp_path):
    tool = _tool("npy_read_peak")
    artifact = os.path.join(toy_run["root"], "distances",
                            f"{min(DATASETS)}-dist.h5")
    out = tmp_path / "read.json"
    tool.main(["-a", artifact, "--trees", ROOT, "--order", "0", "0",
               "--out-json", str(out)])
    runs = json.loads(out.read_text())["runs"]
    with ArtifactStore(artifact, "r") as st:
        want = st.read("Distance")
    assert len(runs) == 2
    for run in runs:
        assert run["container"].startswith(os.path.join(ROOT, ""))
        assert run["bytes"] == want.nbytes
        assert run["shape"] == list(want.shape)
        assert run["device"] == "cpu"
