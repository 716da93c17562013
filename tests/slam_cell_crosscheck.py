"""One cell of the SLAM study on the CPU through both packages with the
same inputs: the JAX package's features and its key tree.

    JAX_PLATFORMS=cpu python tests/slam_cell_crosscheck.py \\
        --header vgg_generated_64.i --scene 48 --seed 99

The study tools of the two packages (``tools/slam_study.py --platform
cpu`` and ``python -m opencv_dlco_tpu_torch.tools.slam_study --device
cpu``) each describe the frames themselves and draw their own RANSAC
samples (the JAX key tree; the port's ``DeviceDraws``). This script
removes both differences: the frames of render_blob_sequence(seed) are
described once by the JAX package, and the port's run_odometry and
run_back_end get JAX's default keys (PRNGKey(0), PRNGKey(1)) through
``test_torch_slam.JaxKeys``. What is left between the two rows is the
arithmetic of the pose chunk (f32 8-point solves, RANSAC scoring,
two-view BA) and what follows from it. Besides each package's row, it
prints how many pose estimates of each batched_pair_poses call differ
between the packages (rotation > 1e-3 rad or translation cosine < 0.999)
and, for the consecutive and backbone pairs, each package's median
rotation error and count of translations within 25 degrees of the
ground-truth relative pose. Last, for the first consecutive and
stride-2 pairs, it prints how RANSAC (JAX's, on its own draws) decides:
the hypotheses within one inlier of the best, and the conditioning of
the weighted 8-point refit on the winner's inliers (the two smallest
eigenvalues of A^T A in f64, and one f32 rounding of A^T A's largest
eigenvalue beside them). It is a diagnostic, not a test: pytest does not
collect it.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from opencv_dlco_tpu.data.synthetic import render_blob_sequence  # noqa
from opencv_dlco_tpu.geometry.epipolar import (  # noqa: E402
    eight_point, ransac_essential, sampson_distance)
from opencv_dlco_tpu.models.vgg import VGGDescriptor  # noqa: E402
from opencv_dlco_tpu.pipeline import slam as js  # noqa: E402

from opencv_dlco_tpu_torch.pipeline import slam as ps  # noqa: E402

from test_torch_slam import JaxKeys, _angle, _cos  # noqa: E402

STUDY_CFG = dict(n_keypoints=256, kf_min_translation=2.5,
                 kf_min_rotation=0.05, loop_gap=10)


def gt_relative(n_frames, a, b, radius=1.5):
    """Frame a -> frame b pose of render_blob_sequence's closed circle."""
    def pose(i):
        th = 2 * np.pi * i / n_frames
        yaw = 0.03 * np.sin(th)
        r_wc = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                         [-np.sin(yaw), 0, np.cos(yaw)]])
        return r_wc, np.array([radius * (np.cos(th) - 1.0),
                               radius * np.sin(th), 0.0])
    ra, ca = pose(a)
    rb, cb = pose(b)
    return rb.T @ ra, rb.T @ (ca - cb)


def ransac_conditioning(feats, a, b, intr, cfg, key):
    """RANSAC's margin and the refit's conditioning for frames (a, b),
    matched as the pose chunk matches them (2-NN, ratio test, valid)."""
    import jax.numpy as jnp
    from opencv_dlco_tpu.ops.knn import knn_match, ratio_test

    fx, fy, cx, cy = intr
    (yx_a, d_a, v_a), (yx_b, d_b, v_b) = feats[a], feats[b]
    d_bm = np.where(v_b[:, None], d_b, -1e6)
    dist, idx = knn_match(jnp.asarray(d_a), jnp.asarray(d_bm), k=2,
                          precision="highest")
    m, ok = ratio_test(dist, idx, ratio=cfg.ratio)
    src = np.flatnonzero(np.asarray(ok) & v_a)
    tgt = np.asarray(m)[src]
    x1 = np.stack([(yx_a[src, 1] - cx) / fx, (yx_a[src, 0] - cy) / fy],
                  -1).astype(np.float32)
    x2 = np.stack([(yx_b[tgt, 1] - cx) / fx, (yx_b[tgt, 0] - cy) / fy],
                  -1).astype(np.float32)
    draws = jax.random.randint(key, (cfg.ransac_iters, 8), 0, len(src))
    e_all = jax.vmap(lambda i: eight_point(jnp.asarray(x1)[i],
                                           jnp.asarray(x2)[i]))(draws)
    scores = np.asarray(sampson_distance(e_all, jnp.asarray(x1)[None],
                                         jnp.asarray(x2)[None])
                        < cfg.ransac_thresh).sum(1)
    _, mask, _ = ransac_essential(jnp.asarray(x1), jnp.asarray(x2), key,
                                  n_hypotheses=cfg.ransac_iters,
                                  thresh=cfg.ransac_thresh)
    h1 = np.c_[x1, np.ones(len(x1))].astype(np.float64)
    h2 = np.c_[x2, np.ones(len(x2))].astype(np.float64)
    rows = (h2[:, :, None] * h1[:, None, :]).reshape(-1, 9)
    rows = rows * np.asarray(mask, np.float64)[:, None]
    ev = np.linalg.eigvalsh(rows.T @ rows)
    return {"pair": [a, b], "matches": int(len(src)),
            "within_one_of_best": int((scores >= scores.max() - 1).sum()),
            "ev_ratio": float(ev[1] / ev[0]),
            "f32_rounding_over_ev0": float(np.finfo(np.float32).eps
                                           * ev[-1] / ev[0])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--header", required=True)
    ap.add_argument("--scene", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    with open(args.header) as fh:
        model = VGGDescriptor.from_header(fh.read())
    frames, gt, intr = render_blob_sequence(
        np.random.default_rng(args.seed), args.scene, size=256)
    feats = [tuple(np.asarray(x) for x in f) for f in js.compute_features(
        frames, model, js.SlamConfig(**STUDY_CFG))]
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))

    calls = {}
    for tag, mod in (("jax", js), ("port", ps)):
        inner = mod.batched_pair_poses

        def record(f, idx, *a, _tag=tag, _inner=inner, **kw):
            out = _inner(f, idx, *a, **kw)
            calls.setdefault(_tag, []).append(
                ([tuple(map(int, p)) for p in idx], out[0]))
            return out
        mod.batched_pair_poses = record

    rows = {}
    for tag in ("jax", "port"):
        stats = {}
        t0 = time.perf_counter()
        if tag == "jax":
            cfg = js.SlamConfig(**STUDY_CFG)
            odo = js.run_odometry(frames, intr, None, cfg, feats=feats)
            ref = js.run_back_end(odo, feats, intr, cfg, loop_stats=stats)
        else:
            cfg = ps.SlamConfig(**STUDY_CFG)
            odo = ps.run_odometry(frames, intr, None, cfg,
                                  key=JaxKeys(jax.random.PRNGKey(0)),
                                  feats=feats, device="cpu")
            ref = ps.run_back_end(odo, feats, intr, cfg,
                                  key=JaxKeys(jax.random.PRNGKey(1)),
                                  loop_stats=stats, device="cpu")
        pose_err = []
        for pairs, ests in calls[tag][:2]:
            angs, good = [], 0
            for (a, b), e in zip(pairs, ests):
                r, t = gt_relative(args.scene, a, b)
                angs.append(_angle(e.rotation, r))
                good += _cos(e.translation, t) > np.cos(np.radians(25))
            pose_err.append({"pairs": len(pairs),
                             "median_rot_err": float(np.median(angs)),
                             "t_within_25deg": int(good)})
        rows[tag] = dict(
            scene=args.scene, seed=args.seed,
            ate_odo=round(ps.ate_rmse(odo.translations, gt) / span, 4),
            ate_ref=round(ps.ate_rmse(ref.translations, gt) / span, 4),
            n_loops=len(ref.loop_edges),
            loops=[(int(i), int(j)) for i, j, *_ in ref.loop_edges],
            n_keyframes=len(ref.keyframes),
            stride=(int(np.median(np.diff(odo.nodes)))
                    if odo.nodes is not None else 1),
            seconds=round(time.perf_counter() - t0, 1),
            pose_vs_gt=pose_err,
            **{f"loop_{k}": v for k, v in stats.items()})
        print(tag, json.dumps(rows[tag]), flush=True)
    differing = []
    for (pa, ea), (pb, eb) in zip(calls["jax"], calls["port"]):
        n_diff = sum(_angle(x.rotation, y.rotation) > 1e-3
                     or _cos(x.translation, y.translation) < 0.999
                     for x, y in zip(ea, eb))
        differing.append([len(pa), pa == pb, int(n_diff)])
    print("calls [pairs, same pair list, estimates differing]:",
          json.dumps(differing), flush=True)
    cfg = js.SlamConfig(**STUDY_CFG)
    for a, b in ((0, 1), (4, 5), (0, 2), (10, 12), (6, 8)):
        print("ransac:", json.dumps(ransac_conditioning(
            feats, a, b, intr, cfg, jax.random.PRNGKey(3))), flush=True)
    return rows


if __name__ == "__main__":
    main()
