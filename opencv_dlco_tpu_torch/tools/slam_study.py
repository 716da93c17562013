"""Multi-seed SLAM robustness study.

Port of ``tools/slam_study.py``. Runs the SLAM bench scenes
(render_blob_sequence at 48/192/512 frames) across seeds and SlamConfig
overrides, printing one JSON row per (scene, seed) with odometry/refined
ATE-over-span, loop counts, and the per-gate loop-rejection counters of
detect_loop_closures: the instrument for finding why a seed misses its
loop closure. Each row also carries the backbone's stride and node
count, kernel G's launches in the cell, and a hash of the odometry's and
the refined trajectory's poses (two runs of one cell agree bit for bit
when the hashes do).

Usage (on the card; ``--device cpu`` for the plain path):
    python -m opencv_dlco_tpu_torch.tools.slam_study --header vgg_generated_64.i \\
        --scenes 48,192 --seeds 2215,7,99
    python -m opencv_dlco_tpu_torch.tools.slam_study --header vgg_generated_64.i \\
        --set loop_top_k=4 --set loop_mutual=0

With ``--out``, rows are merged by (scene, seed) into that JSON file:
``{"command", "card", "torch", "header": {"file", "sha1", "n_pr",
"pj_dim", "pj_in"}, "rows": [...]}``. A file written with another
header is refused, not merged.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shlex
import sys
import time

import numpy as np


def parse_override(kv: str):
    k, v = kv.split("=", 1)
    try:
        val = int(v)
    except ValueError:
        try:
            val = float(v)
        except ValueError:
            val = v
    return k, val


def poses_sha1(res) -> str:
    """A hash of a trajectory's poses, bit for bit."""
    return hashlib.sha1(np.ascontiguousarray(res.rotations).tobytes()
                        + np.ascontiguousarray(res.translations).tobytes()
                        ).hexdigest()[:12]


def study_config(**overrides):
    """The study's SlamConfig (the bench row's), with ``overrides``."""
    from ..pipeline.slam import SlamConfig

    return SlamConfig(n_keypoints=256, kf_min_translation=2.5,
                      kf_min_rotation=0.05, loop_gap=10, **overrides)


def render_cell(n_frames: int, seed: int):
    """The cell's scene: render_blob_sequence(default_rng(seed), n_frames,
    256 px), as (frames, ground-truth centers, intrinsics)."""
    from ..data.synthetic import render_blob_sequence

    return render_blob_sequence(np.random.default_rng(seed), n_frames,
                                size=256)


def run_cell(n_frames: int, seed: int, model, cfg, overrides: dict,
             device, scene=None):
    """One (scene, seed) run through compute_features -> run_odometry ->
    run_back_end (the bench's calls), on ``scene`` when the cell was
    rendered already (``render_cell``). Returns the JSON row, the
    odometry and the refined result; the row's ``wall`` counts the SLAM
    calls, not the rendering."""
    from ..ops.knn_fused import knn2_fused_batched
    from ..pipeline.slam import (ate_rmse, compute_features, run_back_end,
                                 run_odometry)

    frames, centers_gt, intr = (render_cell(n_frames, seed) if scene is None
                                else scene)
    g0 = knn2_fused_batched.launches
    t0 = time.perf_counter()
    feats = compute_features(frames, model, cfg)
    odo = run_odometry(frames, intr, model, cfg, feats=feats, device=device)
    loop_stats = {}
    refined = run_back_end(odo, feats, intr, cfg, loop_stats=loop_stats,
                           device=device)
    wall = time.perf_counter() - t0
    span = float(np.linalg.norm(centers_gt.max(0) - centers_gt.min(0)))
    row = dict(
        scene=n_frames, seed=seed,
        ate_odo=round(float(ate_rmse(odo.translations, centers_gt)) / span,
                      4),
        ate_ref=round(float(ate_rmse(refined.translations, centers_gt))
                      / span, 4),
        n_loops=len(refined.loop_edges),
        n_keyframes=len(refined.keyframes),
        wall=round(wall, 1),
        overrides=overrides,
        **{f"loop_{k}": v for k, v in loop_stats.items()},
        stride=(int(np.median(np.diff(odo.nodes)))
                if odo.nodes is not None else 1),
        n_nodes=(len(odo.nodes) if odo.nodes is not None else n_frames),
        g_launches=knn2_fused_batched.launches - g0,
        odo_sha1=poses_sha1(odo), ref_sha1=poses_sha1(refined))
    return row, odo, refined


def study_row(n_frames: int, seed: int, model, cfg, overrides: dict,
              device) -> dict:
    """One (scene, seed) run (``run_cell``) as a JSON row."""
    return run_cell(n_frames, seed, model, cfg, overrides, device)[0]


def header_facts(path: str, text: str) -> dict:
    """The descriptor's file name, sha1 and matrix shapes."""
    from ..pipeline.export import parse_vgg_header

    mats = parse_vgg_header(text)
    return {"file": os.path.basename(path),
            "sha1": hashlib.sha1(text.encode()).hexdigest(),
            "n_pr": int(mats["PR"].shape[0]),
            "pj_dim": int(mats["PJ"].shape[0]),
            "pj_in": int(mats["PJ"].shape[1])}


def merge_rows(path: str, rows, meta: dict) -> dict:
    """Merge rows into the study file at ``path`` by (scene, seed), sorted
    by that key, under ``meta`` (command, card, header); returns what was
    written. A file whose header differs from ``meta``'s is refused."""
    merged = {}
    if os.path.exists(path):
        with open(path) as fh:
            old = json.load(fh)
        if old["header"]["sha1"] != meta["header"]["sha1"]:
            raise ValueError(f"{path} holds rows of header "
                             f"{old['header']['sha1']}, not "
                             f"{meta['header']['sha1']}")
        merged = {(r["scene"], r["seed"]): r for r in old["rows"]}
    for r in rows:
        merged[(r["scene"], r["seed"])] = r
    out = {**meta, "rows": [merged[k] for k in sorted(merged)]}
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m opencv_dlco_tpu_torch.tools.slam_study",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenes", default="48,192,512")
    ap.add_argument("--seeds", default="2215,7,99")
    ap.add_argument("--set", action="append", default=[],
                    help="SlamConfig override key=val (repeatable)")
    ap.add_argument("--out", default=None, help="merge JSON rows here")
    ap.add_argument("--header", required=True,
                    help="vgg_generated .i header (the descriptor)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    import torch

    from ..models.vgg import VGGDescriptor
    from ..pipeline.e2e import card_description

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("CUDA is not available; pass --device cpu for the plain "
                 "PyTorch path")
    with open(args.header) as fh:
        text = fh.read()
    model = VGGDescriptor.from_header(text, device=dev)
    overrides = dict(parse_override(kv) for kv in args.set)
    # int-typed bool fields arrive as ints; SlamConfig handles truthiness
    cfg = study_config(**overrides)

    rows = []
    for n_frames in (int(s) for s in args.scenes.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            row = study_row(n_frames, seed, model, cfg, overrides,
                            args.device)
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        merge_rows(args.out, rows, {
            "command": shlex.join(["python", "-m", __spec__.name]
                                  + (sys.argv[1:] if argv is None
                                     else list(argv))),
            "card": (card_description(dev) if dev.type == "cuda"
                     else "cpu"),
            "torch": torch.__version__,
            "header": header_facts(args.header, text)})
    return rows


if __name__ == "__main__":
    main()
