"""The port's SLAM study tool (``python -m
opencv_dlco_tpu_torch.tools.slam_study``) on a stub run: its flags, its
row format (the JAX tool's keys, tools/slam_study.py) and the ``--out``
merge by (scene, seed). No SLAM runs here; ``study_row`` is replaced by
a stub that returns rows in its format."""

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
        merged = json.load(fh)
    assert [(r["scene"], r["seed"]) for r in merged] == [
        (48, 7), (48, 2215), (192, 7), (192, 2215), (512, 7)]
    assert merged[0]["overrides"] == {} and merged[1]["overrides"] == {
        "loop_top_k": 4}

