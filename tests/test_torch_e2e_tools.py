"""The measurement tools around the ``e2e`` command, on the CPU at the toy
shape of tests/test_torch_e2e.py: ``tools/e2e_memory_run.py``'s stage
wrappers, ``tools/compdist_profile.py``'s parts and
``tools/npy_read_peak.py``'s per-tree reads. They measure on the card;
here they run the plain path, to show that they time every stage of
``run_full``, leave the package as they found it, and that the profile's
parts compute the stage's own rows. The bf16 route
(``--matmul-precision default``) runs at tests/test_torch_stage3_route.py's
bank, whose shape takes kernel A's route, with the e2e command replaced
by ``run_reference_scale`` at that file's toy shape.
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
from test_torch_stage3_route import chain_kw

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


def _no_card(mp):
    """The tools' card calls made no-ops: the run is on the CPU."""
    for name in ("synchronize", "reset_peak_memory_stats"):
        mp.setattr(torch.cuda, name, lambda *a, **kw: None)
    for name in ("max_memory_allocated", "max_memory_reserved"):
        mp.setattr(torch.cuda, name, lambda *a, **kw: 0)
    mp.setattr(torch.cuda, "is_available", lambda: True)


@pytest.fixture(scope="module")
def bf16_tool_run(tmp_path_factory):
    """``e2e_memory_run.main`` with ``--matmul-precision default`` and the
    pass-through flags, the e2e command run at the toy shape on the CPU."""
    tool = _tool("e2e_memory_run")
    tmp = tmp_path_factory.mktemp("e2e_bf16")
    root, out, mem = (str(tmp / "ws"), str(tmp / "summary.json"),
                      str(tmp / "mem.json"))
    seen = {}

    def e2e_command(argv):
        seen["argv"] = list(argv)
        seen["workspace_cls"] = stages.Workspace
        kw = chain_kw(root)
        kw.update(n_pairs=int(argv[argv.index("--n-pairs") + 1]),
                  pj_iters=int(argv[argv.index("--pj-iters") + 1]),
                  out_json=argv[argv.index("--out-json") + 1])
        run_reference_scale(argv[argv.index("-w") + 1], device="cpu", **kw)

    argv = ["-w", root, "--out-json", out, "--mem-json", mem,
            "--n-pairs", "200", "--pj-iters", "40",
            "--matmul-precision", "default"]
    with pytest.MonkeyPatch.context() as mp:
        _no_card(mp)
        mp.setattr(tool.cli, "main", e2e_command)
        mp.setattr(tool, "card_line", lambda: "cpu")
        tool.main(argv)
        with pytest.raises(SystemExit, match="stage-3 output"):
            tool.main(argv)
    with open(out) as fh, open(mem) as fm:
        return dict(tool=tool, root=root, argv=argv, seen=seen,
                    summary=json.load(fh), mem=json.load(fm))


def test_memory_run_bf16_names_precision_and_route(bf16_tool_run):
    run = bf16_tool_run
    for rec in (run["summary"], run["mem"]):
        assert rec["matmul_precision"] == "default"
        assert rec["stage3_route"] == "kernel_A"
    n_ds = len(run["summary"]["datasets"])
    # one 8,192-pair block a dataset of 200 pairs, none on the f32 route
    assert run["mem"]["stage3_calls"] == {"kernel_A": n_ds, "f32": 0}
    assert run["seen"]["argv"] == ["e2e", "-w", run["root"], "--out-json",
                                   run["argv"][3], "--n-pairs", "200",
                                   "--pj-iters", "40"]
    assert run["mem"]["argv"] == run["seen"]["argv"]
    assert run["summary"]["n_pairs"] == 200
    assert run["summary"]["pj_iters_per_combo"] == 40
    opted = run["seen"]["workspace_cls"]
    assert opted is not stages.Workspace and issubclass(opted,
                                                        stages.Workspace)
    assert opted(run["root"], device="cpu").desc_cfg == \
        pcfg.DescriptorConfig(matmul_precision="default")
    assert stages.Workspace(run["root"], device="cpu").desc_cfg == \
        pcfg.DescriptorConfig()
    assert all(rec["ok"] for rec in run["summary"]["exports"].values())


def test_memory_run_refuses_a_used_workspace(bf16_tool_run, tmp_path):
    tool = bf16_tool_run["tool"]
    # the fixture's second call on its finished workspace raised; a
    # workspace with only a sharded stage-3 store is refused too
    os.makedirs(tmp_path / "distances" / "x-dist.shards")
    assert tool.stage3_artifacts(str(tmp_path)) == ["x-dist.shards"]
    assert tool.stage3_artifacts(str(tmp_path / "none")) == []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(SystemExit, match="x-dist.shards"):
            tool.main(["-w", str(tmp_path), "--out-json", "o", "--mem-json",
                       "m", "--matmul-precision", "default"])


def test_compdist_profile_bf16_parts_compute_the_stage_rows(bf16_tool_run,
                                                            tmp_path):
    tool = _tool("compdist_profile")
    out = tmp_path / "profile.json"
    ds = min(bf16_tool_run["summary"]["datasets"])
    tool.main(["-w", bf16_tool_run["root"], "--ds", ds, "--blocks", "3",
               "--pair-block", "64", "--device", "cpu",
               "--matmul-precision", "default", "--out-json", str(out)])
    got = json.loads(out.read_text())
    assert (got["precision"], got["route"]) == ("default", "kernel_A")
    for part in ("split", "program", "profiled"):
        assert got[part]["rows_equal_stage_output"], part
    # the f32 route's parts do not reproduce the bf16 stage's rows
    tool.main(["-w", bf16_tool_run["root"], "--ds", ds, "--blocks", "1",
               "--pair-block", "64", "--device", "cpu",
               "--out-json", str(out)])
    got = json.loads(out.read_text())
    assert got["route"] == "f32"
    assert not got["split"]["rows_equal_stage_output"]
