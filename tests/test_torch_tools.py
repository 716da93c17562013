"""The port's SLAM study tool (``python -m
opencv_dlco_tpu_torch.tools.slam_study``) on a stub run: its flags, its
row format (the JAX tool's keys, tools/slam_study.py) and the ``--out``
merge by (scene, seed). No SLAM runs here; ``study_row`` is replaced by
a stub that returns rows in its format."""

import hashlib
import json

import numpy as np
import pytest

from opencv_dlco_tpu_torch.pipeline.export import emit_vgg_header
from opencv_dlco_tpu_torch.tools import slam_study

#: the keys of tools/slam_study.py's rows (before the loop counters)
ROW_KEYS = {"scene", "seed", "ate_odo", "ate_ref", "n_loops", "n_keyframes",
            "wall", "overrides"}


@pytest.fixture
def stub(monkeypatch, tmp_path):
    calls = []

    def study_row(n_frames, seed, model, cfg, overrides, device):
        calls.append((n_frames, seed, cfg.loop_top_k, device,
                      model.projection.device.type))
        return dict(scene=n_frames, seed=seed, ate_odo=0.1, ate_ref=0.05,
                    n_loops=1, n_keyframes=9, wall=0.0, overrides=overrides,
                    loop_candidates=3, loop_accepted=1)

    monkeypatch.setattr(slam_study, "study_row", study_row)
    rng = np.random.default_rng(0)
    header = tmp_path / "vgg_generated_8.i"
    header.write_text(emit_vgg_header(
        rng.uniform(0, 1, (4, 4096)).astype(np.float32),
        rng.standard_normal((8, 32)).astype(np.float32)))
    return calls, str(header)


def test_parse_override():
    assert slam_study.parse_override("loop_top_k=4") == ("loop_top_k", 4)
    assert slam_study.parse_override("ratio=0.8") == ("ratio", 0.8)
    assert slam_study.parse_override("x=abc") == ("x", "abc")


def test_header_is_required():
    with pytest.raises(SystemExit):
        slam_study.main(["--scenes", "48"])


def test_rows_and_out_merge(stub, tmp_path, capsys):
    calls, header = stub
    out = str(tmp_path / "study.json")
    rows = slam_study.main(["--header", header, "--device", "cpu",
                            "--scenes", "48,192", "--seeds", "7,2215",
                            "--set", "loop_top_k=4", "--out", out])
    assert [c[:2] for c in calls] == [(48, 7), (48, 2215), (192, 7),
                                      (192, 2215)]
    assert all(c[2:] == (4, "cpu", "cpu") for c in calls)
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == rows
    for r in rows:
        assert ROW_KEYS <= set(r) and r["overrides"] == {"loop_top_k": 4}
        assert all(k.startswith("loop_") for k in set(r) - ROW_KEYS)
    # a second run replaces its (scene, seed) rows and keeps the others
    slam_study.main(["--header", header, "--device", "cpu", "--scenes",
                     "48,512", "--seeds", "7", "--out", out])
    with open(out) as fh:
        study = json.load(fh)
    merged = study["rows"]
    assert [(r["scene"], r["seed"]) for r in merged] == [
        (48, 7), (48, 2215), (192, 7), (192, 2215), (512, 7)]
    assert merged[0]["overrides"] == {} and merged[1]["overrides"] == {
        "loop_top_k": 4}
    # the file records the last run's command, the device and the header
    assert study["command"].split()[:3] == [
        "python", "-m", "opencv_dlco_tpu_torch.tools.slam_study"]
    assert "--scenes 48,512" in study["command"]
    assert study["card"] == "cpu"
    with open(header) as fh:
        text = fh.read()
    assert study["header"] == {
        "file": "vgg_generated_8.i",
        "sha1": hashlib.sha1(text.encode()).hexdigest(),
        "n_pr": 4, "pj_dim": 8, "pj_in": 32}


def test_out_refuses_rows_of_another_header(stub, tmp_path):
    _, header = stub
    out = str(tmp_path / "study.json")
    slam_study.main(["--header", header, "--device", "cpu", "--scenes",
                     "48", "--seeds", "7", "--out", out])
    other = tmp_path / "vgg_generated_other.i"
    rng = np.random.default_rng(1)
    other.write_text(emit_vgg_header(
        rng.uniform(0, 1, (4, 4096)).astype(np.float32),
        rng.standard_normal((8, 32)).astype(np.float32)))
    with pytest.raises(ValueError, match="holds rows of header"):
        slam_study.main(["--header", str(other), "--device", "cpu",
                         "--scenes", "48", "--seeds", "7", "--out", out])


def test_cuda_is_required_unless_cpu_is_asked(stub, monkeypatch):
    import torch

    calls, header = stub
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        slam_study.main(["--header", header, "--scenes", "48"])
    assert calls == []


def test_run_cell_row_on_the_cpu():
    """The row of one real cell (12 frames, 128 keypoints; a 64-D header
    of 96 ring-bank rows and a seeded projection): the JAX tool's keys,
    the loop counters, the backbone, G's launches (0 on the CPU) and the
    pose hashes."""
    from opencv_dlco_tpu_torch.models.vgg import VGGDescriptor
    from opencv_dlco_tpu_torch.ops.pool_regions import build_filter_bank
    from opencv_dlco_tpu_torch.pipeline.slam import SlamConfig
    from opencv_dlco_tpu_torch.utils.configs import PoolRegionConfig

    rng = np.random.default_rng(31)
    _, _, bank = build_filter_bank(PoolRegionConfig(nr=16, nphi=2, nsigma=4))
    sel = bank[rng.choice(bank.shape[0], 96, replace=False)]
    pj = rng.standard_normal((64, 768)) / np.sqrt(768)
    model = VGGDescriptor.from_header(emit_vgg_header(
        sel.astype(np.float32), pj.astype(np.float32)), device="cpu")
    cfg = SlamConfig(n_keypoints=128, kf_min_translation=2.5,
                     kf_min_rotation=0.05, loop_gap=10)
    row, odo, refined = slam_study.run_cell(12, 2215, model, cfg, {}, "cpu")
    assert ROW_KEYS <= set(row) and row["scene"] == 12
    assert {"loop_n_candidates", "loop_accepted"} <= set(row)
    assert row["n_nodes"] == (12 if odo.nodes is None else len(odo.nodes))
    assert row["g_launches"] == 0
    assert row["odo_sha1"] == slam_study.poses_sha1(odo)
    assert row["ref_sha1"] == slam_study.poses_sha1(refined)
    assert refined.translations.shape == (12, 3)
    assert np.isfinite(refined.translations).all()

