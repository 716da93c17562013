"""Multi-seed SLAM robustness study.

Port of ``tools/slam_study.py``. Runs the SLAM bench scenes
(render_blob_sequence at 48/192/512 frames) across seeds and SlamConfig
overrides, printing one JSON row per (scene, seed) with odometry/refined
ATE-over-span, loop counts, and the per-gate loop-rejection counters of
detect_loop_closures: the instrument for finding why a seed misses its
loop closure.

Usage (on the card; ``--device cpu`` for the plain path):
    python -m opencv_dlco_tpu_torch.tools.slam_study --header vgg_generated_64.i \\
        --scenes 48,192 --seeds 2215,7,99
    python -m opencv_dlco_tpu_torch.tools.slam_study --header vgg_generated_64.i \\
        --set loop_top_k=4 --set loop_mutual=0

With ``--out``, rows are merged into that JSON file by (scene, seed).
"""

from __future__ import annotations

import argparse
import json
import os
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


def study_row(n_frames: int, seed: int, model, cfg, overrides: dict,
              device) -> dict:
    """One (scene, seed) run through compute_features -> run_odometry ->
    run_back_end (the bench's calls), as a JSON row."""
    from ..data.synthetic import render_blob_sequence
    from ..pipeline.slam import (ate_rmse, compute_features, run_back_end,
                                 run_odometry)

    rng = np.random.default_rng(seed)
    frames, centers_gt, intr = render_blob_sequence(rng, n_frames, size=256)
    t0 = time.perf_counter()
    feats = compute_features(frames, model, cfg)
    odo = run_odometry(frames, intr, model, cfg, feats=feats, device=device)
    loop_stats = {}
    refined = run_back_end(odo, feats, intr, cfg, loop_stats=loop_stats,
                           device=device)
    span = float(np.linalg.norm(centers_gt.max(0) - centers_gt.min(0)))
    return dict(
        scene=n_frames, seed=seed,
        ate_odo=round(float(ate_rmse(odo.translations, centers_gt)) / span,
                      4),
        ate_ref=round(float(ate_rmse(refined.translations, centers_gt))
                      / span, 4),
        n_loops=len(refined.loop_edges),
        n_keyframes=len(refined.keyframes),
        wall=round(time.perf_counter() - t0, 1),
        overrides=overrides,
        **{f"loop_{k}": v for k, v in loop_stats.items()})


def merge_rows(path: str, rows) -> list:
    """Merge rows into the JSON list at ``path`` by (scene, seed), sorted by
    that key; returns the merged list."""
    merged = {}
    if os.path.exists(path):
        with open(path) as fh:
            merged = {(r["scene"], r["seed"]): r for r in json.load(fh)}
    for r in rows:
        merged[(r["scene"], r["seed"])] = r
    out = [merged[k] for k in sorted(merged)]
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

    from ..models.vgg import VGGDescriptor
    from ..pipeline.slam import SlamConfig

    with open(args.header) as fh:
        model = VGGDescriptor.from_header(fh.read(), device=args.device)
    overrides = dict(parse_override(kv) for kv in args.set)
    # int-typed bool fields arrive as ints; SlamConfig handles truthiness
    cfg = SlamConfig(n_keypoints=256, kf_min_translation=2.5,
                     kf_min_rotation=0.05, loop_gap=10, **overrides)

    rows = []
    for n_frames in (int(s) for s in args.scenes.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            row = study_row(n_frames, seed, model, cfg, overrides,
                            args.device)
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        merge_rows(args.out, rows)
    return rows


if __name__ == "__main__":
    main()
