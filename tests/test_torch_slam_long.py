"""The port's SLAM past 48 frames held against the JAX package: the
backbone's 32-node floor, a stride above 1 and its re-measured widening,
the node layout, the skip-pair repair and fusion over many nodes,
``_hang_intermediates``, loop closure and the Sim(3) graph.

At 64 frames and more ``run_odometry``'s node floor is
``min_backbone_nodes`` = 32 (below, ``n_frames // 2``), so the stride is
capped at ``n_frames // 32``. Two runs reach that code in both packages:

- The whole path (``run_odometry``, ``run_back_end``) on exact-geometry
  features of 64 frames of a closed-loop camera path: a 3D point field
  at depths 4-10 projected with 0.02 px noise and 10% mismatched
  descriptors, as in tests/test_torch_slam.py, seen through a wide field
  of view (f = 120 px on 192 px frames). With f = 300 the consecutive
  pairs' rotation and translation trade off at this parallax, and the
  two packages' f32 solves land on different, equally wrong poses for
  some pairs; the wide view makes the consensus unambiguous. Both packages get the JAX key tree (``JaxKeys``). The
  consecutive parallax asks for stride 3; the floor caps it at 2, 33
  nodes. Tolerances: identical backbone pair lists, nodes, keyframes,
  loop edge pairs and loop counters; ATE/span within 0.01; every pose
  within 2% of the trajectory's extent and 5e-3 rad.
- The widening: ``run_odometry`` over 96 frames with the pair estimator
  replaced, in both packages, by the scene's exact relative poses and
  landmarks (consecutive pairs report their nearest 20% of common
  points, wider pairs all of them). The consecutive median asks for
  stride 2, the re-measure on the stride-2 backbone for 3, the cap
  (96 // 32); the loop's second pass keeps 3. Tolerances: the same pair
  lists and nodes, poses within 1e-4 of the extent.
"""

import numpy as np
import pytest
import torch

import jax

from opencv_dlco_tpu.pipeline import slam as js

from opencv_dlco_tpu_torch.pipeline import slam as ps

from test_torch_slam import JaxKeys, _angle

SIZE, FOCAL, BORDER = 192, 120.0, 32
CFG = dict(n_keypoints=128, ransac_iters=128, pose_chunk=16, ba_iters=10,
           kf_min_translation=0.25, kf_min_rotation=0.05, loop_gap=6)


def camera_path(n_frames, radius):
    """World centers and camera-to-world rotations of the closed circle."""
    centers, rots = [], []
    for i in range(n_frames):
        th = 2 * np.pi * i / n_frames
        centers.append(np.array([radius * (np.cos(th) - 1.0),
                                 radius * np.sin(th), 0.0]))
        yaw = 0.03 * np.sin(th)
        rots.append(np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                              [-np.sin(yaw), 0, np.cos(yaw)]]))
    return np.stack(centers), np.stack(rots)


def path_scene(n_frames, radius=1.5, k=128, n_pts=3000, dim=64,
               noise_px=0.02, outliers=0.1, seed=7):
    """Per-frame (yx_f, desc, valid) of a point field seen along the
    path; also each frame's point ids by keypoint slot (-1 empty) and
    each point's frame coordinates, for exact pair estimates."""
    rng = np.random.default_rng(seed)
    c = SIZE / 2.0
    pts = np.stack([rng.uniform(-6 - 2 * radius, 6, n_pts),
                    rng.uniform(-6 - radius, 6 + radius, n_pts),
                    rng.uniform(4, 10, n_pts)], 1)
    codes = rng.standard_normal((n_pts, dim)).astype(np.float32)
    centers, rots = camera_path(n_frames, radius)
    feats, slots, cam_pts = [], [], []
    for center, r_wc in zip(centers, rots):
        p = (pts - center) @ r_wc
        u = FOCAL * p[:, 0] / p[:, 2] + c
        v = FOCAL * p[:, 1] / p[:, 2] + c
        vis = np.flatnonzero((u >= BORDER) & (u < SIZE - BORDER)
                             & (v >= BORDER) & (v < SIZE - BORDER)
                             & (p[:, 2] > 0.1))[:k]
        m = len(vis)
        yx = np.zeros((k, 2), np.float32)
        desc = np.full((k, dim), 1e6, np.float32)
        valid = np.zeros(k, bool)
        yx[:m] = np.stack([v[vis], u[vis]], 1) + rng.normal(0, noise_px,
                                                              (m, 2))
        desc[:m] = codes[vis] + rng.normal(0, 0.05, (m, dim))
        bad = np.flatnonzero(rng.random(m) < outliers)
        desc[bad] = rng.standard_normal((len(bad), dim))
        valid[:m] = True
        feats.append((yx, desc, valid))
        slot = np.full(k, -1)
        slot[:m] = vis
        slots.append(slot)
        cam_pts.append(p)
    return feats, centers, (FOCAL, FOCAL, c, c), slots, cam_pts, rots


def _span(gt):
    return float(np.linalg.norm(gt.max(0) - gt.min(0)))


def _record_pairs(mp, mod, calls, depths=None):
    """Record each batched_pair_poses call's pair list (and, into
    ``depths``, each call's per-pair median landmark depth)."""
    inner = mod.batched_pair_poses

    def record(feats, pair_indices, *a, **kw):
        calls.append([(int(i), int(j)) for i, j in pair_indices])
        ests, ok = inner(feats, pair_indices, *a, **kw)
        if depths is not None:
            depths.append([float(np.median(e.points3d[:, 2])) for e in ests
                           if e.points3d.shape[0] >= 8])
        return ests, ok
    mp.setattr(mod, "batched_pair_poses", record)


@pytest.fixture(scope="module")
def long_runs():
    """Both packages' run_odometry and run_back_end on 64 frames, one key
    tree, with every pair list batched_pair_poses was given."""
    feats, gt, intr, *_ = path_scene(64)
    k_odo, k_back = jax.random.split(jax.random.PRNGKey(0), 2)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for tag, mod in (("jax", js), ("port", ps)):
            calls, depths = [], []
            _record_pairs(mp, mod, calls, depths)
            cfg = mod.SlamConfig(**CFG)
            stats = {}
            if tag == "jax":
                odo = js.run_odometry(None, intr, None, cfg, key=k_odo,
                                      feats=feats)
                ref = js.run_back_end(odo, feats, intr, cfg, key=k_back,
                                      loop_stats=stats)
            else:
                odo = ps.run_odometry(None, intr, None, cfg,
                                      key=JaxKeys(k_odo), feats=feats,
                                      device="cpu")
                ref = ps.run_back_end(odo, feats, intr, cfg,
                                      key=JaxKeys(k_back), loop_stats=stats,
                                      device="cpu")
            out[tag] = dict(odo=odo, ref=ref, stats=stats, calls=calls,
                            depths=depths)
    return out, gt, feats


def _strides(call):
    return sorted({j - i for i, j in call})


def test_floor_and_capped_stride_reached_in_both(long_runs):
    runs, gt, feats = long_runs
    n = len(feats)
    cfg = ps.SlamConfig(**CFG)
    assert max(16, min(cfg.min_backbone_nodes, n // 2)) == 32
    cap = n // 32
    for tag in ("jax", "port"):
        odo, calls = runs[tag]["odo"], runs[tag]["calls"]
        # consecutive pairs, the stride-2 backbone, its skip pairs, loops
        assert _strides(calls[0]) == [1] and len(calls[0]) == n - 1
        assert _strides(calls[1]) == [1, cap], tag   # last node appended
        assert len(calls[2]) == len(calls[1]) - 1
        # the consecutive parallax asked for more than the floor allows
        meds = runs[tag]["depths"][0]
        assert np.ceil(np.median(meds) * cfg.target_parallax) > cap, tag
        assert odo.nodes is not None and len(odo.nodes) >= 32
        assert int(np.median(np.diff(odo.nodes))) == cap
    assert runs["port"]["calls"][:3] == runs["jax"]["calls"][:3]


def test_nodes_keyframes_and_loops_match_jax(long_runs):
    runs, gt, _ = long_runs
    ours, ref = runs["port"], runs["jax"]
    np.testing.assert_array_equal(ours["odo"].nodes, ref["odo"].nodes)
    assert len(ours["odo"].skip_edges) == len(ref["odo"].skip_edges)
    assert ours["calls"] == ref["calls"]     # the loop candidates too
    np.testing.assert_array_equal(ours["ref"].keyframes,
                                  ref["ref"].keyframes)
    edges = [(i, j) for i, j, *_ in ours["ref"].loop_edges]
    assert edges == [(i, j) for i, j, *_ in ref["ref"].loop_edges]
    assert edges, "the closed loop is detected"
    assert ours["stats"] == ref["stats"]
    assert ours["stats"]["accepted"] >= 1


@pytest.mark.parametrize("which", ["odo", "ref"])
def test_poses_match_jax(long_runs, which):
    runs, gt, _ = long_runs
    a, b = runs["port"][which], runs["jax"][which]
    assert a.translations.shape == b.translations.shape == (len(gt), 3)
    assert np.all(np.isfinite(a.translations))
    extent = _span(b.translations)
    assert np.abs(a.translations - b.translations).max() < 0.02 * extent
    assert max(_angle(x, y) for x, y in zip(a.rotations, b.rotations)) \
        < 5e-3
    span = _span(gt)
    ate, ate_ref = (ps.ate_rmse(x.translations, gt) / span for x in (a, b))
    assert abs(ate - ate_ref) < 0.01, (ate, ate_ref)
    assert ate < 0.05


# -- the stride's widening, on exact pair estimates ---------------------------

def exact_estimator(mod, slots, cam_pts, rots, centers, near_frac=0.2):
    """A batched_pair_poses for ``mod`` returning the scene's exact
    relative poses: unit translation, landmarks in frame a at that scale,
    all usable. Consecutive pairs keep their nearest ``near_frac`` of
    common points (a depth-biased first estimate); wider pairs keep all."""
    def estimate(feats, pair_indices, intrinsics, cfg, key, device=None):
        ests = []
        for a, b in pair_indices:
            r = rots[b].T @ rots[a]
            t = rots[b].T @ (centers[a] - centers[b])
            scale = float(np.linalg.norm(t))
            ids, ia, ib = np.intersect1d(slots[a][slots[a] >= 0],
                                         slots[b][slots[b] >= 0],
                                         return_indices=True)
            pts = cam_pts[a][ids] / scale
            if b - a == 1:
                keep = np.argsort(pts[:, 2], kind="stable")[
                    :int(near_frac * len(ids))]
                keep.sort()
                ia, ib, pts = ia[keep], ib[keep], pts[keep]
            ests.append(mod.PairEstimate(
                rotation=r.astype(np.float32),
                translation=(t / scale).astype(np.float32),
                kp_prev_idx=ia.astype(np.int32),
                kp_next_idx=ib.astype(np.int32),
                points3d=pts.astype(np.float32), n_inliers=len(ia),
                n_matches=len(ia)))
        return ests, [True] * len(ests)
    return estimate


def test_stride_widens_to_the_floor_in_both():
    feats, gt, intr, slots, cam_pts, rots = path_scene(96, radius=2.5)
    n = len(feats)
    cap = n // 32
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for tag, mod in (("jax", js), ("port", ps)):
            calls = []
            mp.setattr(mod, "batched_pair_poses",
                       exact_estimator(mod, slots, cam_pts, rots, gt))
            _record_pairs(mp, mod, calls)
            cfg = mod.SlamConfig(**CFG)
            kw = dict(key=jax.random.PRNGKey(0)) if tag == "jax" else dict(
                key=ps.DeviceDraws(0, "cpu"), device="cpu")
            out[tag] = mod.run_odometry(None, intr, None, cfg, feats=feats,
                                        **kw), calls
    (ours, calls), (ref, ref_calls) = out["port"], out["jax"]
    assert calls == ref_calls
    # consecutive, the backbone at 2, widened to 3 = the cap (each with
    # the last frame appended as a node), then the skips over 2 nodes
    assert [_strides(c) for c in calls] == [[1], [1, 2], [2, cap],
                                            [2 * cap - 1, 2 * cap]]
    for res in (ours, ref):
        nodes = res.nodes
        assert list(nodes[:-1]) == list(range(0, n - 1, cap))
        assert nodes[-1] == n - 1 and len(nodes) >= 32
    np.testing.assert_array_equal(ours.nodes, ref.nodes)
    extent = _span(ref.translations)
    assert np.abs(ours.translations - ref.translations).max() \
        < 1e-4 * extent
    assert ps.ate_rmse(ours.translations, gt) / _span(gt) < 1e-3


def test_device_draws_never_repeat_across_chunks():
    """The production draw source over a 512-frame run's worth of pose
    chunks: every chunk's table is fresh (no wrap of the stream)."""
    draws = ps.DeviceDraws(0, "cpu")
    hi = torch.full((16,), 200)
    seen = set()
    for _ in range(64):
        tab = ps._ransac_tables(draws.split(16), hi, 512, 8)
        assert tab.shape == (16, 512, 8)
        assert bool((tab >= 0).all()) and bool((tab < 200).all())
        for row in tab.reshape(-1, 512 * 8):
            key = row.numpy().tobytes()
            assert key not in seen
            seen.add(key)
