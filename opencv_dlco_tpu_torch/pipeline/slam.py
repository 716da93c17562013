"""Sequential monocular odometry / SLAM over an image sequence.

Port of ``opencv_dlco_tpu/pipeline/slam.py``, structured like a production
monocular system:

- per-frame detect+describe ONCE (features shared by odometry, loop
  detection and windowed BA);
- consecutive-pair matching -> batched RANSAC essential -> cheirality pose
  -> two-view BA, monocular scale propagated through landmarks shared by
  overlapping pairs (depth-ratio voting on common keypoints);
- motion-based keyframe selection;
- loop-closure DETECTION: global-descriptor retrieval over keyframes
  (mean-pooled local descriptors) + geometric verification (descriptor
  matching, RANSAC essential, inlier gate) + depth-ratio scale recovery —
  detected, not injected;
- windowed bundle adjustment: multi-frame tracks chained from the pair
  correspondences, triangulated and refined per window through
  geometry/mvba.multi_view_ba; the refined consecutive relative poses
  replace the odometry edges (local-BA + pose-graph architecture);
- a pose-graph solve over the whole trajectory fusing refined odometry
  edges and loop closures. Evaluation: Umeyama-aligned ATE-RMSE.

The device work is the pose chunk (``_match_pose_chunk``): C frame pairs
matched by kernel G (``ops/knn_fused.knn2_fused_batched``, one launch per
chunk; its plain version on CPU tensors), then batched RANSAC, cheirality
pose and two-view BA over the chunk; plus detection/description, the
windowed MVBA and the pose graphs. The host code between them is the
reference's numpy, copied.

Randomness: every function that samples takes a draw source ``key`` with
``split(n)`` (n child sources, as ``jax.random.split``) and
``ransac_idx(hi, n_hyp, sample)`` (uniform sample indices in [0, hi)).
``DeviceDraws`` is the production source, one seeded ``torch.Generator``
on the device, drawing each chunk's tables there with no host sync; tests
pass a source that replays the JAX key tree.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry.ba import two_view_ba
from ..geometry.epipolar import ransac_essential, recover_pose
from ..geometry.mvba import build_landmark_table, multi_view_ba
from ..geometry.posegraph import (optimize_pose_graph,
                                  optimize_pose_graph_sharded,
                                  optimize_pose_graph_sim3,
                                  optimize_pose_graph_sim3_sharded)
from ..geometry.triangulate import triangulate_points
from ..models.vgg import VGGDescriptor
from ..ops.detect import detect_corners, extract_patches
from ..ops.knn import ratio_test
from ..ops.knn_fused import knn2_fused_batched


class DeviceDraws:
    """The SLAM functions' draw source: one seeded ``torch.Generator`` on
    ``device``. ``split`` hands out views of the same stream (independent
    draws, deterministic in call order); ``ransac_idx`` draws the tables of
    a whole chunk in one call, on the device."""

    def __init__(self, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def split(self, n: int) -> list:
        return [self] * n

    def ransac_idx(self, hi, n_hyp: int, sample: int) -> torch.Tensor:
        """(..., n_hyp, sample) int64 uniform in [0, hi) for hi (...,):
        floor(u * hi) of f32 uniforms, clamped below hi."""
        hi = torch.as_tensor(hi, device=self.device)
        u = torch.rand(hi.shape + (n_hyp, sample), generator=self.gen,
                       device=self.device)
        hb = hi[..., None, None]
        return torch.minimum((u * hb).floor().long(), hb.long() - 1)


def _ransac_tables(keys, hi: torch.Tensor, n_hyp: int, sample: int):
    """(C, n_hyp, sample) sample tables of a chunk, one per pair's source
    (``ransac_idx`` of a scalar bound): one draw for the whole chunk when
    every pair shares a stream (DeviceDraws.split)."""
    first = keys[0]
    if len(keys) > 1 and all(k is first for k in keys):
        return first.ransac_idx(hi, n_hyp, sample)
    return torch.stack([k.ransac_idx(hi[c], n_hyp, sample)
                        for c, k in enumerate(keys)]).to(hi.device)


def _resolve_device(device, model) -> torch.device:
    """The caller's device, else the model's, else cuda."""
    if device is not None:
        return torch.device(device)
    if model is not None:
        return model.projection.device
    return torch.device("cuda")


def _f32(device, *arrays):
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in arrays)


def _i64(device, *arrays):
    return tuple(torch.as_tensor(np.asarray(a, np.int64), device=device)
                 for a in arrays)


@dataclass
class SlamConfig:
    n_keypoints: int = 384
    ratio: float = 0.9
    ransac_iters: int = 512
    ransac_thresh: float = 2e-5
    ba_iters: int = 8
    min_matches: int = 16
    min_scale_points: int = 5
    # keyframe selection (motion-based; translation in propagated-scale units)
    kf_min_rotation: float = 0.04       # rad accumulated since last keyframe
    kf_min_translation: float = 0.25
    # scale backbone: when consecutive-frame parallax falls below
    # ``target_parallax`` (rad), chain monocular scale over strided
    # wider-baseline pairs instead — narrow-baseline triangulated depths
    # are noise-dominated and the per-frame scale chain compounds that
    # noise multiplicatively (the KITTI-frame-rate failure mode)
    auto_stride: bool = True
    target_parallax: float = 0.05
    max_stride: int = 32
    # the backbone is also the back end's node set: too-wide strides starve
    # loop-closure retrieval/windowed BA of nodes, so the stride never
    # shrinks the graph below this many nodes
    min_backbone_nodes: int = 32
    # redundant-edge odometry: besides the node chain (stride s), estimate
    # skip pairs node k -> k+2 (stride 2s), repair direction-flipped chain
    # edges by scale-free triangle consistency, and fuse both edge sets in
    # a local Huber pose graph. A single bad chain edge on a short
    # sequence is then repaired/outvoted instead of corrupting every
    # downstream pose. DEFAULT ON since round 4: the round-3 blocker
    # (repair shifted keyframe selection and lost the 128-frame seam
    # closure) is fixed by decoupling keyframe selection from the
    # repaired hop lengths (SlamResult.plain_hops) — measured by the JAX
    # package on its TPU bench scenes, odometry improves on every row (48: 0.237 ->
    # 0.193, 192: 0.207 -> 0.149, 512: 0.208 -> 0.142x span) and every
    # refined row meets the 0.10x-span bar (0.084 / 0.094 / 0.068)
    odo_redundant: bool = True
    odo_skip_weight: float = 0.5     # skip spans 2 steps (~2x covariance)
    # cross-check the chained per-pair scales against the skip pairs' own
    # hop measurements (robust log-scale solve, _skip_scale_refine) before
    # any gating — overlapping skips arbitrate single bad chain votes.
    # Opt-in: on the JAX package's TPU bench scenes it improves raw
    # odometry (192: 0.149 -> 0.139, 512: 0.142 -> 0.125x span) but the
    # refined rows move within seed noise and a 3-seed study showed no
    # consistent refined-ATE win, so the default keeps the plain chain
    odo_scale_refine: bool = False
    odo_skip_max_mad: float = 0.3    # scale-vote agreement gate (log-MAD)
    # an SE(3) skip edge is only fused when its measured hop length agrees
    # with the chained hop within this factor: a scale-discrepant pair is
    # a monocular scale glitch neither side can arbitrate locally (the
    # Sim(3) back end owns global scale) and fusing it as a rigid
    # constraint tears the graph apart — measured on the 128-frame drift
    # scene, glitch edges disagree 4-10x while sound ones sit within 1.4x
    odo_skip_scale_gate: float = 1.6
    # triangle repair: max rotation-composition error (rad) for a skip
    # estimate to vote on its chain edges' translation signs
    odo_tri_max_rot: float = 0.2
    # flip-vote thresholds of the triangle test (a flip needs the flipped
    # nonneg fit residual to beat the kept one by this ratio AND clear the
    # absolute bar; a keep vote needs the same ratio the other way)
    odo_flip_ratio: float = 0.5
    odo_flip_max_res: float = 0.3
    # min nonneg-fit coefficient for a triangle to carry sign information
    # about a leg (below it, the other leg explains the skip alone and
    # the residual ordering is noise — wrong flips on straight scenes)
    odo_flip_min_coeff: float = 0.15
    # rolling-median velocity prior on chained hop lengths, CONDITIONAL
    # on a low-quality chain vote (see _chain_scales): clamp the hop
    # into [med/c, med*c] of the last odo_vel_window accepted hops only
    # when the vote carries no signal (missing or MAD > 0.3); 0
    # disables. The JAX package's TPU multi-seed study: flips the (48,
    # seed 99) cell under the bar while leaving good-vote chains
    # untouched.
    odo_vel_clamp: float = 1.5
    odo_vel_window: int = 5
    # flip votes additionally require the two chain legs to be
    # ANTIPARALLEL (u.v < -this): a real sign flip points against its
    # neighbour, while near-collinear legs make the sign test
    # ill-conditioned (straight-line wrong-flip failure mode)
    odo_flip_neg_uv: float = 0.5
    # loop-closure detection
    loop_gap: int = 12                  # min frame separation
    loop_top_k: int = 2                 # retrieval candidates per keyframe
    loop_min_inliers: int = 24
    loop_min_inlier_ratio: float = 0.35  # inliers / matches gate
    loop_mutual: bool = True            # mutual top-k retrieval consistency
    loop_cluster_frames: int = 0        # temporal dedup radius (0 = gap//2)
    # endpoint scale-vote ratio: under Sim(3) the ratio IS the edge's
    # relative-scale measurement (drift signal), bounded only by a loose
    # sanity cap; under SE(3) (which cannot absorb scale mismatch) the
    # tight consistency gate + geometric mean applies instead
    loop_scale_consistency: float = 1.6  # SE(3)-only tight gate
    loop_scale_sanity: float = 25.0      # Sim(3) sanity cap on the ratio
    # self-scaling re-visit test: accept a loop only if the measured direct
    # hop is shorter than this fraction of the odometry path between the
    # frames (near-neighbour "loops" have direct ~ path and add nothing
    # but vote noise; 0 disables)
    loop_path_ratio: float = 0.6
    loop_vote_max_mad: float = 0.3      # max log-ratio MAD of a scale vote
    loop_min_vote_points: int = 12      # min depth-ratio votes per endpoint
    # merged-map retry of a failed endpoint vote: forward-pair depths
    # first (unchanged behaviour when they pass), then one retry on the
    # forward+backward merged map (_endpoint_depths) — the multi-seed
    # study's fix for vote-count loop misses (seeds 7/99 at 48 frames)
    loop_vote_merge: bool = True
    # Sim(3) map-alignment fallback when the depth-ratio vote fails: a
    # true revisit has a near-zero loop baseline, so the loop pair's OWN
    # triangulated depths (which the vote divides by) are junk there —
    # the study's measured seed-miss mode. The fallback aligns the two
    # endpoints' backprojected ODOMETRY landmarks (trimmed Umeyama) and
    # uses the loop pair only for correspondences; gated on alignment
    # inliers, relative RMS, and rotation agreement with the 2-view
    # estimate (radians). Sim(3) graphs only — an SE(3) graph cannot
    # absorb the relative-scale measurement this path produces.
    loop_sim3_fallback: bool = True
    loop_sim3_max_res: float = 0.15     # RMS / median depth of alignment
    loop_sim3_max_rot: float = 0.25    # max angle vs essential-matrix R
    # weak-vote acceptance: at a TRUE revisit the loop pair's near-zero
    # baseline makes its triangulated depths — the vote denominators —
    # inherently noisy, so the MAD gate rejects exactly the
    # drift-collapsing closures (multi-seed study: MAD 0.34-0.65 on the
    # ground-truth-closest candidates while seed 2215 slips under 0.3).
    # A vote that fails the strict MAD gate but stays under
    # loop_vote_weak_mad is kept as a WEAK scale measurement; the edge
    # is then admitted only as a strong revisit — its direct hop must be
    # under loop_weak_path_ratio x the odometry path (vs the normal
    # loop_path_ratio) — where magnitude precision is secondary to the
    # drift collapse and the DCS kernel + soft Sim(3) scale weight
    # absorb the residual scale noise.
    # the weak cap is deliberately high: the decision to ADMIT a weak
    # edge rests on overwhelming geometric consensus (the inlier-ratio
    # floor below — measured revisits sit at 0.84-0.93 while mid-
    # sequence junk is under 0.7) plus the revisit margin; the MAD cap
    # only discards votes whose median carries no information at all
    loop_vote_weak_mad: float = 1.0
    loop_weak_path_ratio: float = 0.3
    loop_weak_min_inlier_ratio: float = 0.75
    loop_weight: float = 1.0            # pose-graph weight of loop edges
    use_sim3: bool = True               # Sim(3) graph when loops detected
    # robust pose-graph kernel (only engaged when loop edges are present:
    # an odometry-only chain has no redundancy for IRLS to exploit, and a
    # delta calibrated there would be degenerate — all residuals ~0)
    pg_robust: str = "dcs"              # "none" | "huber" | "dcs"
    pg_robust_scale: float = 4.0        # delta^2 = scale * median loop chi2
    pg_gnc_iters: int = 8               # graduated non-convexity anneal
    pg_iters: int = 25                  # LM iterations of the final solve
    # windowed bundle adjustment
    ba_window: int = 6                  # frames per window (0 disables)
    ba_stride: int = 3
    ba_max_tracks: int = 384
    ba_window_iters: int = 10
    # batched front end: frame pairs per pose chunk (one kernel-G launch
    # and one batched RANSAC/BA per chunk; bigger chunks amortise launch
    # latency on long sequences)
    pose_chunk: int = 16


@dataclass
class PairEstimate:
    rotation: np.ndarray        # frame i -> i+1
    translation: np.ndarray     # scaled (after propagation)
    kp_prev_idx: np.ndarray     # inlier keypoint indices in frame i
    kp_next_idx: np.ndarray     # their matched keypoint indices in frame i+1
    points3d: np.ndarray        # landmarks in frame-i coordinates
    n_inliers: int
    n_matches: int = 0          # ratio-test survivors fed to RANSAC


@dataclass
class SlamResult:
    rotations: np.ndarray       # (F, 3, 3) world_T_frame (frame 0 = world)
    translations: np.ndarray    # (F, 3)
    pairs: List[PairEstimate] = field(default_factory=list)
    keyframes: np.ndarray = field(default_factory=lambda: np.empty(0, int))
    loop_edges: List[Tuple[int, int, np.ndarray, np.ndarray]] = \
        field(default_factory=list)
    # scale backbone (None when consecutive parallax was sufficient):
    # frame ids of the backbone nodes and their strided pair estimates —
    # the back end (keyframes/loops/BA/pose graph) runs on these
    nodes: Optional[np.ndarray] = None
    bb_pairs: Optional[List[PairEstimate]] = None
    # redundant node k -> k+2 skip edges (node-index space, trajectory
    # scale) fused at odometry time and re-used by the back-end graph
    skip_edges: Optional[List[Tuple[int, int, np.ndarray, np.ndarray]]] = None
    # hop lengths |t_k| of the PLAIN (un-repaired) scale chain, one per
    # backbone pair — when present, keyframe selection reads these instead
    # of the repaired estimates, so the back end's keyframe set (and with
    # it which candidate pair represents a loop seam) is invariant to the
    # redundant-edge repair (round-3 bisect: repair shifted keyframe
    # selection and lost the 128-frame seam at the scale-vote MAD gate)
    plain_hops: Optional[np.ndarray] = None


def compute_features(frames, model: VGGDescriptor, cfg: SlamConfig,
                     chunk: int = 8):
    """Detect + describe every frame once; shared by all downstream stages.

    Keypoint coordinates are sub-pixel refined (parabolic fit) — at the
    ~9 px disparities of consecutive frames, integer centres alone put
    >10% noise on triangulated depths, which poisons monocular scale
    propagation.

    Frames go to the model's device in chunks of ``chunk`` equal-shape
    frames: detection batches over the frame axis and description runs
    (chunk * K) patches at once. Returns one (yx_f (K, 2) f32, desc (K, D)
    f32, valid (K,)) numpy tuple per frame; invalid keypoints' descriptors
    are 1e6, so they never match."""
    frames = [np.asarray(f) for f in frames]
    dev = model.projection.device
    feats = []
    i = 0
    while i < len(frames):
        # uniform-shape run starting at i
        j = i + 1
        while (j < len(frames) and j - i < chunk
               and frames[j].shape == frames[i].shape):
            j += 1
        imgs = torch.from_numpy(np.stack(frames[i:j])).to(dev)
        _, yx, valid, yx_f = detect_corners(imgs, k=cfg.n_keypoints,
                                            subpixel=True)
        patches = extract_patches(imgs, yx)               # (C, K, P, P)
        c, k_pts = patches.shape[:2]
        desc = model.describe(patches.reshape((c * k_pts,)
                                              + patches.shape[2:]))
        desc = desc.reshape(c, k_pts, -1)
        desc = torch.where(valid[..., None], desc,
                           torch.full_like(desc, 1e6))
        yx_f_np = yx_f.cpu().numpy()
        desc_np = desc.cpu().numpy()
        valid_np = valid.cpu().numpy()
        for m in range(j - i):
            feats.append((yx_f_np[m], desc_np[m], valid_np[m]))
        i = j
    return feats


def _match_pose_chunk(yx_a, d_a, v_a, yx_b, d_b, v_b, intr, keys, *,
                      ratio, thresh, n_hypotheses, ba_iters, min_matches):
    """Match + RANSAC-E + cheirality pose + two-view BA for a CHUNK of C
    frame pairs, batched over the chunk on the device.

    The C matching problems go to kernel G in one launch (its plain version
    on CPU tensors), f32 with TF32 off: pose quality is sensitive to match
    identity. Invalid query rows arrive at 1e6 and invalid train rows are
    set to -1e6, so neither is ever a real row's neighbour. Variable match
    counts become static shapes through the compact-to-prefix + ``n_valid``
    contract of geometry.epipolar.ransac_essential; the RANSAC tables are
    drawn after matching (their bound depends on the match count) from
    ``keys``, one source per pair.

    Returns per pair: r (3,3), t (3), points (K, 3), good (K,), src (K,),
    tgt (K,), n_matches (), n_inliers (), usable ().
    """
    k_pts = yx_a.shape[1]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    d_bm = torch.where(v_b[..., None], d_b, torch.full_like(d_b, -1e6))
    dists, idx = knn2_fused_batched(d_a, d_bm, bf16=False)

    midx, ok = ratio_test(dists.reshape(-1, 2), idx.reshape(-1, 2),
                          ratio=ratio)
    midx, ok = midx.reshape(v_a.shape), ok.reshape(v_a.shape) & v_a
    # compact valid matches to the front (stable: keeps kp order)
    order = torch.argsort((~ok).to(torch.int8), dim=-1, stable=True)
    src = order.to(torch.int32)
    tgt = torch.gather(torch.clamp(midx, min=0), 1, order).to(torch.int32)
    n_ok = ok.sum(-1).to(torch.int32)

    def take_xy(yx, sel):
        pts = torch.gather(yx, 1, sel.long()[..., None].expand(-1, -1, 2))
        return torch.stack([(pts[..., 1] - cx) / fx,
                            (pts[..., 0] - cy) / fy], -1).to(torch.float32)

    x1 = take_xy(yx_a, src)
    x2 = take_xy(yx_b, tgt)

    table = _ransac_tables(keys, torch.clamp(n_ok, 8, k_pts), n_hypotheses,
                           8)
    e, mask, n_inl = ransac_essential(x1, x2, table, thresh=thresh,
                                      n_valid=n_ok)
    r, t, pts, _ = recover_pose(e, x1, x2, mask)
    # padded / outlier rows can triangulate to degenerate points; park
    # them at a benign depth so BA's jacobians stay finite (their weight
    # is 0, but NaN * 0 would still poison the normal equations)
    pts = torch.where(mask[..., None], pts,
                      torch.tensor([0.0, 0.0, 5.0], dtype=pts.dtype,
                                   device=pts.device))
    ba = two_view_ba(r, t, pts, x1, x2, weights=mask.to(torch.float32),
                     n_iters=ba_iters)
    # cheirality-clean landmarks only: a triangulation behind either camera
    # is geometric junk and poisons depth-ratio scale voting
    z2 = torch.sum(ba.points * ba.r[:, None, 2, :], -1) + ba.t[:, None, 2]
    good = mask & (ba.points[..., 2] > 1e-6) & (z2 > 1e-6)
    usable = n_ok >= min_matches
    return (ba.r, ba.t, ba.points, good & usable[:, None], src, tgt, n_ok,
            n_inl, usable)


def batched_pair_poses(feats, pair_indices, intrinsics, cfg: SlamConfig,
                       key, device="cuda"
                       ) -> Tuple[List["PairEstimate"], List[bool]]:
    """Relative poses for many (a, b) frame pairs, in chunks of
    ``cfg.pose_chunk`` pairs on ``device``.

    Matching runs ONCE per pair; each estimate carries both endpoint
    keypoint indices so callers never re-match. Pairs with fewer than
    ``cfg.min_matches`` correspondences come back with usable=False
    instead of raising — loop-closure candidates are allowed to fail.
    ``key`` is split into one draw source per pair.
    """
    n_pairs = len(pair_indices)
    if n_pairs == 0:
        return [], []
    dev = torch.device(device)
    yx_all = torch.from_numpy(np.stack([f[0] for f in feats]).astype(
        np.float32)).to(dev)
    d_all = torch.from_numpy(np.stack([f[1] for f in feats]).astype(
        np.float32)).to(dev)
    v_all = torch.from_numpy(np.stack([f[2] for f in feats])).to(dev)
    intr = torch.tensor(np.asarray(intrinsics, np.float32), device=dev)
    keys = key.split(n_pairs)
    a_idx = torch.as_tensor([p[0] for p in pair_indices], device=dev)
    b_idx = torch.as_tensor([p[1] for p in pair_indices], device=dev)

    ests: List[PairEstimate] = []
    usable_flags: List[bool] = []
    chunk = max(1, cfg.pose_chunk)
    for s in range(0, n_pairs, chunk):
        e = min(s + chunk, n_pairs)
        ai, bi = a_idx[s:e], b_idx[s:e]
        out = _match_pose_chunk(
            yx_all[ai], d_all[ai], v_all[ai], yx_all[bi], d_all[bi],
            v_all[bi], intr, keys[s:e],
            ratio=cfg.ratio, thresh=cfg.ransac_thresh,
            n_hypotheses=cfg.ransac_iters, ba_iters=cfg.ba_iters,
            min_matches=cfg.min_matches)
        r, t, pts, good, src, tgt, n_ok, n_inl, usable = (
            x.cpu().numpy() for x in out)
        for p in range(e - s):
            # drop non-finite landmarks (degenerate triangulations can
            # survive the cheirality gate with finite z but NaN x/y) and
            # refuse estimates whose pose itself is non-finite
            g = good[p] & np.isfinite(pts[p]).all(-1)
            pose_ok = bool(np.isfinite(r[p]).all() and
                           np.isfinite(t[p]).all())
            ests.append(PairEstimate(
                rotation=r[p],
                translation=t[p],
                kp_prev_idx=src[p][g],
                kp_next_idx=tgt[p][g],
                points3d=pts[p][g],
                n_inliers=int(n_inl[p]),
                n_matches=int(n_ok[p]),
            ))
            usable_flags.append(bool(usable[p]) and pose_ok)
    return ests, usable_flags


def _median_depth_ratio(depths: np.ndarray, kp_idx, points3d,
                        min_points: int) -> Optional[float]:
    """Median over common keypoints of (known depth / new landmark depth).

    ``depths`` is a dense (K,) array with NaN where no depth is known."""
    scale, _, _ = _depth_ratio_stats(depths, kp_idx, points3d, min_points)
    return scale


def _depth_ratio_stats(depths: np.ndarray, kp_idx, points3d,
                       min_points: int
                       ) -> Tuple[Optional[float], int, float]:
    """(median scale, vote count, log-ratio MAD) of the depth-ratio vote.

    The MAD measures the vote's internal agreement: loop-closure scale
    votes with wide spread are depth-association junk and the edges they
    scale poison the pose graph (measured: votes with MAD > ~0.4 err by
    2-3x against ground truth on the 192-frame bench scene)."""
    z = points3d[:, 2]
    with np.errstate(invalid="ignore", divide="ignore"):
        ratios = depths[kp_idx] / np.where(z > 1e-6, z, np.nan)
    ratios = ratios[np.isfinite(ratios) & (ratios > 0)]
    if ratios.size < min_points:
        return None, int(ratios.size), float("nan")
    lr = np.log(ratios)
    med = float(np.median(lr))
    mad = float(np.median(np.abs(lr - med)))
    return float(np.exp(med)), int(ratios.size), mad


def _depth_map(kp_idx, depths_z, n_keypoints: int) -> np.ndarray:
    """Dense (K,) depth array (NaN = unknown); duplicate kp: last wins."""
    out = np.full(n_keypoints, np.nan, np.float64)
    ok = depths_z > 1e-6
    out[kp_idx[ok]] = depths_z[ok]
    return out


def _endpoint_depths(pairs: Sequence["PairEstimate"], n_kp: int,
                     f: int) -> np.ndarray:
    """Merged odometry depth map for frame f's keypoints: forward pair
    (f, f+1) landmarks, NaN-filled from the BACKWARD pair (f-1, f)'s
    landmarks transformed into frame f (exactly _chain_scales' pts_next,
    so both sources are in the same chained-scale units — the chaining
    step median-matched them on the shared frame). Doubles the depth
    coverage of a loop-closure scale vote without loosening any gate:
    the vote pool at a keyframe is otherwise only the keypoints that
    happen to be inliers of ONE odometry pair, and the multi-seed study
    measured exactly that thinness (vote-count failures) deciding
    whether a true loop closes (tools/slam_study.py, seeds 7/99)."""
    fwd = (_depth_map(pairs[f].kp_prev_idx, pairs[f].points3d[:, 2], n_kp)
           if f < len(pairs) else np.full(n_kp, np.nan, np.float64))
    if f >= 1:
        eb = pairs[f - 1]
        pts_f = eb.points3d @ eb.rotation.T + eb.translation
        back = _depth_map(eb.kp_next_idx, pts_f[:, 2], n_kp)
        fwd = np.where(np.isnan(fwd), back, fwd)
    return fwd


def _umeyama_sim3(src: np.ndarray, dst: np.ndarray):
    """Closed-form Sim(3) (s, R, t) minimising ||dst - (s R src + t)||^2
    (Umeyama 1991) — host numpy, point counts are loop-inlier sized."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    sgn = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sgn[2, 2] = -1.0
    rot = u @ sgn @ vt
    var_s = float((xs ** 2).sum()) / len(src)
    s = float((d * np.diag(sgn)).sum() / max(var_s, 1e-12))
    t = mu_d - s * (rot @ mu_s)
    return s, rot, t


def _sim3_from_landmarks(yx_b, yx_a, z_b, z_a, kp_b, kp_a, intrinsics,
                         min_points: int):
    """Sim(3) loop edge by 3D-3D alignment of ODOMETRY landmarks.

    The depth-ratio vote needs the loop pair's own triangulations, which
    are inherently junk at a true revisit (near-zero direct baseline —
    the multi-seed study's measured failure: votes plentiful but MAD
    0.34-0.65 on the ground-truth-closest candidates). This path uses
    the loop pair ONLY for correspondences: the matched keypoints are
    backprojected through each endpoint's own odometry depth map (wide
    odometry baselines, clean depths), and a trimmed Umeyama aligns the
    two local point clouds — scale, rotation and translation of the
    fb_T_fa closure in one solve (ORB-SLAM's Sim(3) closure transform
    computed map-to-map, Strasdat-style). Returns (s, R, t, n_inliers,
    rel_rms) with X_b ~= s R X_a + t, or None if underdetermined."""
    zb, za = z_b[kp_b], z_a[kp_a]
    ok = (np.isfinite(zb) & np.isfinite(za) & (zb > 1e-6) & (za > 1e-6))
    if int(ok.sum()) < min_points:
        return None
    fx, fy, cx, cy = np.asarray(intrinsics, np.float64)

    def backproj(yx, kp, z):
        y, x = yx[kp, 0].astype(np.float64), yx[kp, 1].astype(np.float64)
        return np.stack([(x - cx) / fx * z, (y - cy) / fy * z, z], -1)

    pts_b = backproj(yx_b, kp_b[ok], zb[ok])
    pts_a = backproj(yx_a, kp_a[ok], za[ok])
    keep = np.ones(len(pts_b), bool)
    s, rot, t = 1.0, np.eye(3), np.zeros(3)
    res = np.zeros(len(pts_b))
    for _ in range(3):                       # trimmed IRLS, 3 rounds
        s, rot, t = _umeyama_sim3(pts_a[keep], pts_b[keep])
        res = np.linalg.norm(pts_b - (s * pts_a @ rot.T + t), axis=-1)
        nxt = res <= 3.0 * max(float(np.median(res[keep])), 1e-9)
        if int(nxt.sum()) < min_points:
            break
        keep = nxt
    n_in = int(keep.sum())
    if n_in < min_points:
        return None
    rms = float(np.sqrt((res[keep] ** 2).mean()))
    depth_scale = float(np.median(pts_b[keep][:, 2]))
    return s, rot, t, n_in, rms / max(abs(depth_scale), 1e-9)


def _chain_scales(pairs: Sequence[PairEstimate], n_kp: int,
                  min_scale_points: int, vel_window: int = 0,
                  vel_clamp: float = 0.0, vote_mad_gate: float = 0.3
                  ) -> None:
    """Monocular scale chaining in place (host, vectorised per pair):
    rescale pair k so landmarks of the shared middle frame agree in depth
    with pair k-1 (median depth ratio over common keypoints).

    ``vel_clamp`` > 0 adds a CONDITIONAL robust velocity prior: when a
    chain vote is low-quality (missing, or log-ratio MAD above
    ``vote_mad_gate``), the hop length is clamped into [med/c, med*c]
    of the rolling median of the last ``vel_window`` hops. Good votes
    pass through untouched — the multi-seed study measured both failure
    directions: junk votes random-walk the hop lengths (192-frame
    scene, hop ratios 0.23-2.36 vs ground truth), while an
    UNconditional clamp overrides sound votes and degraded two
    previously-passing cells. The conditional form is the standard
    monocular smooth-motion assumption applied only where the data
    carries no signal."""
    prev_depths: Optional[np.ndarray] = None  # (K,) z per kp of cur frame
    prev_scale = 1.0
    hops: List[float] = []
    for est in pairs:
        if prev_depths is not None:
            scale, _, mad = _depth_ratio_stats(
                prev_depths, est.kp_prev_idx, est.points3d,
                min_scale_points)
            low_quality = scale is None or (
                vote_mad_gate > 0 and mad > vote_mad_gate)
            if scale is None:
                scale = prev_scale  # carry previous (drift, but no crash)
            # smooth motion bounds consecutive applied scales: a jump
            # beyond 2x is depth-voting noise, clamp against it
            scale = float(np.clip(scale, 0.5 * prev_scale, 2.0 * prev_scale))
            if vel_clamp > 0 and low_quality and len(hops) >= 3:
                t_norm = float(np.linalg.norm(est.translation))
                med = float(np.median(hops[-vel_window:] if vel_window
                                      else hops))
                if t_norm > 1e-12 and med > 1e-12:
                    scale = float(np.clip(scale, med / vel_clamp / t_norm,
                                          med * vel_clamp / t_norm))
            prev_scale = scale
            est.translation = est.translation * scale
            est.points3d = est.points3d * scale
        hops.append(float(np.linalg.norm(est.translation)))
        # landmarks expressed in frame i+1 for the next overlap, keyed by
        # this pair's match-target keypoint (no re-matching needed):
        # X_{i+1} = R X_i + t
        pts_next = est.points3d @ est.rotation.T + est.translation
        prev_depths = _depth_map(est.kp_next_idx, pts_next[:, 2], n_kp)


def _chain_poses(pairs: Sequence[PairEstimate],
                 r0=None, t0=None) -> Tuple[List, List]:
    """Absolute poses from relative estimates (pure numpy — 3x3 composes
    need no device round-trips): x_{k+1} = R x_k + t, so
    world_T_{k+1} = world_T_k ∘ inv([R|t])."""
    rs = [np.eye(3) if r0 is None else r0]
    ts = [np.zeros(3) if t0 is None else t0]
    for est in pairs:
        r_inv = est.rotation.T
        t_inv = -r_inv @ est.translation
        rs.append(rs[-1] @ r_inv)
        ts.append(rs[-2] @ t_inv + ts[-1])
    return rs, ts


def _node_depth_maps(chain_pairs: Sequence[PairEstimate],
                     n_kp: int) -> List[np.ndarray]:
    """Trajectory-unit keypoint depth map of every node frame, read off
    the (already scale-chained) node-chain estimates: node 0 from its own
    pair's landmarks, node k > 0 from the previous pair's landmarks pushed
    forward (X_next = R X + t) — the same association `_chain_scales`
    uses, so no re-matching."""
    maps = [_depth_map(chain_pairs[0].kp_prev_idx,
                       chain_pairs[0].points3d[:, 2], n_kp)]
    for est in chain_pairs:
        pts_next = est.points3d @ est.rotation.T + est.translation
        maps.append(_depth_map(est.kp_next_idx, pts_next[:, 2], n_kp))
    return maps


def _plain_hop_lengths(pairs: Sequence[PairEstimate], n_kp: int,
                       min_scale_points: int, vel_window: int = 0,
                       vel_clamp: float = 0.0) -> np.ndarray:
    """Hop lengths |t_k| of the scale chain run on UNREPAIRED copies of
    the pair estimates (the keyframe-selection decoupling of
    SlamResult.plain_hops; the copies leave the real chain untouched)."""
    copies = [PairEstimate(rotation=est.rotation,
                           translation=est.translation.copy(),
                           kp_prev_idx=est.kp_prev_idx,
                           kp_next_idx=est.kp_next_idx,
                           points3d=est.points3d.copy(),
                           n_inliers=est.n_inliers,
                           n_matches=est.n_matches)
              for est in pairs]
    _chain_scales(copies, n_kp, min_scale_points, vel_window, vel_clamp)
    return np.asarray([float(np.linalg.norm(c.translation))
                       for c in copies])


def _skip_pair_estimates(feats, nodes: Sequence[int], intrinsics,
                         cfg: SlamConfig, key, device="cuda"):
    """Raw node k -> k+2 pair estimates (monocular unit-baseline)."""
    if len(nodes) < 3:
        return [], []
    skip_idx = [(int(nodes[k]), int(nodes[k + 2]))
                for k in range(len(nodes) - 2)]
    return batched_pair_poses(feats, skip_idx, intrinsics, cfg, key,
                              device=device)


def _unit(v: np.ndarray) -> np.ndarray:
    return v / (np.linalg.norm(v) + 1e-12)


def _nn_fit_residual(w: np.ndarray, u: np.ndarray, v: np.ndarray,
                     with_coeffs: bool = False):
    """min over a,b >= 0 of |w - a*u - b*v| (unit vectors; clamped 2x2
    normal solve with active-set fallback — the triangle direction test).
    With ``with_coeffs``, also returns (a, b) — a leg with coefficient
    ~0 contributes nothing to the fit, so the triangle carries no
    information about that leg's SIGN (the wrong-flip failure mode on
    straight scenes: the other leg explains the skip alone and the
    tested leg's sign is decided by fit noise)."""
    g = np.array([[u @ u, u @ v], [u @ v, v @ v]])
    rhs = np.array([u @ w, v @ w])
    ab = np.linalg.solve(g + 1e-9 * np.eye(2), rhs)
    if ab[0] < 0.0:
        ab = np.array([0.0, max(0.0, rhs[1] / g[1, 1])])
    elif ab[1] < 0.0:
        ab = np.array([max(0.0, rhs[0] / g[0, 0]), 0.0])
    res = float(np.linalg.norm(w - ab[0] * u - ab[1] * v))
    if with_coeffs:
        return res, float(ab[0]), float(ab[1])
    return res


def _rot_angle(r: np.ndarray) -> float:
    return float(np.arccos(np.clip((np.trace(r) - 1.0) * 0.5, -1.0, 1.0)))


def _triangle_flip_repair(chain_pairs: Sequence[PairEstimate], skips, ok,
                          feats, nodes: Sequence[int], intrinsics,
                          cfg: SlamConfig, device="cuda") -> int:
    """Detect and repair direction-flipped chain edges, scale-free.

    At low parallax the essential-matrix translation direction is
    sign-ambiguous and cheirality votes are noise: single chain edges come
    back near-OPPOSITE (measured: ~160 deg turn spikes vs the ground
    truth's 15 deg on the 48-frame bench scene), after which the depth-
    ratio scale chain votes through junk landmarks and the whole short
    sequence is lost. The stride-2 skip estimate over each chain-edge pair
    gives a scale-free consistency test: composing X_{k+2} = R2 X_{k+1} +
    t2 with X_{k+1} = R1 X_k + t1 yields skip direction w ~ a*(R2 t1_hat)
    + b*(t2_hat) with UNKNOWN nonnegative a, b — so the nonneg fit
    residual of w on (u, v) is invariant to the monocular scales and flips
    show up as a sign preference. Each triangle votes keep/flip for both
    of its chain edges; edges with net flip votes get t -> -t and their
    landmarks re-triangulated from the stored keypoint matches. Rotation-
    inconsistent skips (bad skip estimates) abstain entirely."""
    m = len(chain_pairs)
    flip_votes = np.zeros(m)
    keep_votes = np.zeros(m)
    for k in range(min(len(skips), m - 1)):
        if not ok[k]:
            continue
        e1, e2, es = chain_pairs[k], chain_pairs[k + 1], skips[k]
        if _rot_angle(es.rotation @ (e2.rotation @ e1.rotation).T) \
                > cfg.odo_tri_max_rot:
            continue
        u = e2.rotation @ _unit(e1.translation)
        v = _unit(e2.translation)
        w = _unit(es.translation)
        r = {(su, sv): _nn_fit_residual(w, su * u, sv * v, with_coeffs=True)
             for su in (1, -1) for sv in (1, -1)}
        # a genuinely sign-flipped chain edge shows up as ANTIPARALLEL
        # legs (u.v ~ -1: the edge points against its neighbour, and the
        # skip decides which of the two is wrong). Near-COLLINEAR legs
        # (u.v ~ +1, straight motion) carry no sign information — the
        # nonneg fit is ill-conditioned there (a*(-u) + b*v with u ~ v
        # reduces to (b-a)*v) and the residual ordering is noise, which
        # produced confident wrong flips on straight scenes. Flip votes
        # therefore require antiparallel legs; agreeing legs may only
        # cast keep votes.
        antiparallel = float(u @ v) < -cfg.odo_flip_neg_uv
        for edge, axis in ((k, 0), (k + 1, 1)):
            r_keep, ck = min((rv[0], rv[1 + axis]) for sg, rv in r.items()
                             if sg[axis] == 1)
            r_flip, cf = min((rv[0], rv[1 + axis]) for sg, rv in r.items()
                             if sg[axis] == -1)
            # the tested leg must also carry weight in the fit — when the
            # other leg explains the skip alone, there is no information
            if max(ck, cf) < cfg.odo_flip_min_coeff:
                continue
            if (antiparallel and r_flip < cfg.odo_flip_ratio * r_keep
                    and r_flip < cfg.odo_flip_max_res):
                flip_votes[edge] += 1.0
            elif r_keep < cfg.odo_flip_ratio * r_flip:
                keep_votes[edge] += 1.0
    fx, fy, cx, cy = np.asarray(intrinsics, np.float64)
    n_flipped = 0
    for k in np.nonzero(flip_votes > keep_votes)[0]:
        est = chain_pairs[int(k)]
        est.translation = -est.translation
        a, b = int(nodes[int(k)]), int(nodes[int(k) + 1])
        yx_a = np.asarray(feats[a][0], np.float64)[est.kp_prev_idx]
        yx_b = np.asarray(feats[b][0], np.float64)[est.kp_next_idx]
        x0 = np.stack([(yx_a[:, 1] - cx) / fx, (yx_a[:, 0] - cy) / fy], -1)
        x1 = np.stack([(yx_b[:, 1] - cx) / fx, (yx_b[:, 0] - cy) / fy], -1)
        pts = triangulate_points(
            *(torch.as_tensor(np.asarray(v, np.float32), device=device)
              for v in (est.rotation, est.translation, x0, x1))
        ).cpu().numpy()
        good = np.isfinite(pts).all(-1) & (pts[:, 2] > 1e-6)
        # No cheirality revert here, deliberately: at the low parallax
        # that produces sign flips, triangulated depths are noise and a
        # CORRECT flip routinely re-triangulates only a handful of
        # in-front landmarks (measured by the JAX package on its TPU: any
        # landmark-count revert bar — absolute or relative — undid every
        # true repair and put the 48-frame row back at 0.21x span vs 0.084
        # with repairs kept). The flip's value is the translation DIRECTION;
        # a sparse/empty landmark set just makes the scale chain carry
        # the previous scale for this hop. est.n_inliers keeps its
        # RANSAC-inlier meaning (pair quality, asserted by tests and
        # read by loop gates on never-repaired loop candidates);
        # points3d/kp_idx may be a smaller, cheirality-clean subset.
        est.points3d = pts[good]
        est.kp_prev_idx = est.kp_prev_idx[good]
        est.kp_next_idx = est.kp_next_idx[good]
        n_flipped += 1
    return n_flipped


def _skip_scale_refine(chain_pairs: Sequence[PairEstimate], skips, ok,
                       cfg: SlamConfig, n_kp: int) -> int:
    """Cross-check the chained per-pair scales against the independent
    skip-pair hop measurements (VERDICT r3: 'the skip-edge scale votes are
    the natural next cross-check' for the compounding scale-chain noise).

    The depth-ratio chain estimates each pair's scale from ONE noisy
    median vote and the errors compound multiplicatively. Each skip pair
    k -> k+2 carries an independent hop length H_k (its own scale vote
    against node k's landmark depths). Because scale corrections never
    touch rotations, pair k's WORLD displacement is c_k * v_k with fixed
    direction v_k, so each skip measures |c_k v_k + c_{k+1} v_{k+1}| —
    and overlapping skips (k-1 -> k+1 and k -> k+2 both span pair k) let
    the solve arbitrate whether the chain hop or a single skip vote is
    the outlier, which the hard accept/reject gate of _gate_skip_edges
    structurally cannot. Robust (Huber) Gauss-Newton over x_k = log c_k
    with a zero prior; skip votes enter soft-weighted by their MAD
    instead of hard-gated. Corrections apply in place to translations AND
    landmarks (downstream depth maps stay consistent). Returns the number
    of corrected pairs (|log c| > 0.01)."""
    m = len(chain_pairs)
    depth_maps = _node_depth_maps(chain_pairs, n_kp)
    meas = {}
    for k, (est, usable) in enumerate(zip(skips, ok)):
        if not usable or k + 1 >= m:
            continue
        scale, _, mad = _depth_ratio_stats(
            depth_maps[k], est.kp_prev_idx, est.points3d,
            cfg.min_scale_points)
        if scale is None or not np.isfinite(mad):
            continue
        w = 1.0 / (1.0 + (mad / max(cfg.odo_skip_max_mad / 2, 1e-6)) ** 2)
        meas[k] = (float(scale * np.linalg.norm(est.translation)), w)
    if len(meas) < 2:
        return 0
    rs, _ = _chain_poses(chain_pairs)
    v = np.stack([rs[k] @ (-chain_pairs[k].rotation.T
                           @ chain_pairs[k].translation)
                  for k in range(m)])                     # world disp/pair
    x = np.zeros(m)                                       # log c_k
    sig_prior, sig_meas, huber = 0.25, 0.12, 1.5
    for _ in range(6):
        g = x / sig_prior ** 2                            # prior gradient
        h = np.full(m, 1.0 / sig_prior ** 2)              # diag GN Hessian
        h_off = np.zeros(m - 1)
        for k, (hk, w) in meas.items():
            c0, c1 = np.exp(x[k]), np.exp(x[k + 1])
            d_vec = c0 * v[k] + c1 * v[k + 1]
            d = float(np.linalg.norm(d_vec))
            if d < 1e-9 or hk < 1e-9:
                continue
            r = (np.log(d) - np.log(hk)) / (sig_meas / np.sqrt(w))
            rho = 1.0 if abs(r) <= huber else huber / abs(r)  # Huber IRLS
            # d log d / d x_k = (c_k v_k . d_vec) / d^2
            jk = float(c0 * v[k] @ d_vec) / d ** 2
            jk1 = float(c1 * v[k + 1] @ d_vec) / d ** 2
            s2 = (sig_meas / np.sqrt(w)) ** 2 / rho
            g[k] += jk * (np.log(d) - np.log(hk)) / s2
            g[k + 1] += jk1 * (np.log(d) - np.log(hk)) / s2
            h[k] += jk * jk / s2
            h[k + 1] += jk1 * jk1 / s2
            h_off[k] += jk * jk1 / s2
        # tridiagonal solve (Thomas algorithm)
        a = h.copy()
        b = h_off.copy()
        rhs = -g.copy()
        for k in range(1, m):
            f = b[k - 1] / a[k - 1]
            a[k] -= f * b[k - 1]
            rhs[k] -= f * rhs[k - 1]
        dx = np.zeros(m)
        dx[-1] = rhs[-1] / a[-1]
        for k in range(m - 2, -1, -1):
            dx[k] = (rhs[k] - b[k] * dx[k + 1]) / a[k]
        x += np.clip(dx, -0.5, 0.5)
        if float(np.max(np.abs(dx))) < 1e-4:
            break
    x = np.clip(x, np.log(0.5), np.log(2.0))              # sanity bound
    n_corr = 0
    for k in range(m):
        c = float(np.exp(x[k]))
        if abs(x[k]) > 0.01:
            n_corr += 1
        chain_pairs[k].translation = chain_pairs[k].translation * c
        chain_pairs[k].points3d = chain_pairs[k].points3d * c
    return n_corr


def _gate_skip_edges(skips, ok, chain_pairs: Sequence[PairEstimate],
                     ts_chain: np.ndarray, cfg: SlamConfig, n_kp: int
                     ) -> List[Tuple[int, int, np.ndarray, np.ndarray]]:
    """Scale and gate raw skip estimates into node k -> k+2 edges.

    Each skip estimate is monocular unit-baseline; its trajectory scale is
    the depth-ratio vote of its source node's chained landmarks, gated on
    (a) internal vote agreement (log-ratio MAD) exactly like loop-closure
    scale votes and (b) hop-length consistency with the chained trajectory
    (``odo_skip_scale_gate``): a scale-discrepant skip pair marks a
    monocular scale glitch the local SE(3) fusion cannot arbitrate — only
    scale-agreeing redundancy (direction/rotation noise averaging) is
    fused. Edges failing any gate are dropped — they are redundancy, not
    structure."""
    depth_maps = _node_depth_maps(chain_pairs, n_kp)
    edges: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
    for k, (est, usable) in enumerate(zip(skips, ok)):
        if not usable:
            continue
        scale, _, mad = _depth_ratio_stats(
            depth_maps[k], est.kp_prev_idx, est.points3d,
            cfg.min_scale_points)
        if scale is None or not np.isfinite(mad) \
                or mad > cfg.odo_skip_max_mad:
            continue
        hop_meas = float(scale * np.linalg.norm(est.translation))
        hop_chain = float(np.linalg.norm(ts_chain[k + 2] - ts_chain[k]))
        g = cfg.odo_skip_scale_gate
        if not (hop_chain / g <= hop_meas <= hop_chain * g):
            continue
        r_z = est.rotation.T                       # i_T_j = inv([R|t])
        t_z = -r_z @ (est.translation * scale)
        edges.append((k, k + 2, r_z, t_z))
    return edges


def _fuse_redundant_chain(rs: np.ndarray, ts: np.ndarray,
                          chain_pairs: Sequence[PairEstimate],
                          skip_edges, cfg: SlamConfig, device="cuda"
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse chained node poses with redundant skip edges in a small Huber
    SE(3) pose graph (node 0 gauge-fixed by the solver's prior).

    The Huber width is calibrated on the SKIP edges' initial chi² (the
    chain residuals are identically zero at the chained init, so a
    whole-graph median would crush every skip edge); with the GNC anneal
    an edge grossly out of family — chain or skip — is downweighted while
    consistent redundancy averages the per-edge noise."""
    m = rs.shape[0]
    ei = list(range(m - 1)) + [e[0] for e in skip_edges]
    ej = list(range(1, m)) + [e[1] for e in skip_edges]
    rz = [est.rotation.T for est in chain_pairs] + [e[2] for e in skip_edges]
    tz = [-est.rotation.T @ est.translation for est in chain_pairs] \
        + [e[3] for e in skip_edges]
    wts = [1.0] * (m - 1) + [cfg.odo_skip_weight] * len(skip_edges)
    init = SlamResult(rotations=rs, translations=ts)
    chi2 = _loop_edge_chi2(init, skip_edges, cfg.odo_skip_weight)
    med_chi2 = float(np.median(chi2))
    # when the gated skip edges agree with the chain almost exactly
    # (median initial chi2 ~ 0), a median-calibrated Huber width would
    # collapse to ~0 and downweight every residual during the solve —
    # including healthy chain edges as they move off the init. Agreement
    # that good needs no robustness: solve plain least squares instead.
    if med_chi2 < 1e-6:
        robust_kwargs = dict(robust="none")
    else:
        delta2 = cfg.pg_robust_scale * med_chi2
        robust_kwargs = dict(robust="huber",
                             robust_delta=float(np.sqrt(delta2)),
                             gnc_iters=min(4, cfg.pg_gnc_iters))
    out = optimize_pose_graph(
        *_f32(device, rs, ts), *_i64(device, ei, ej),
        *_f32(device, np.stack(rz), np.stack(tz), wts),
        n_iters=cfg.pg_iters, **robust_kwargs)
    return (out.r.cpu().numpy().astype(np.float64),
            out.t.cpu().numpy().astype(np.float64))


def run_odometry(frames, intrinsics, model: Optional[VGGDescriptor],
                 cfg: Optional[SlamConfig] = None, key=None,
                 feats=None, device=None) -> SlamResult:
    """Chain consecutive-pair estimates into an absolute trajectory.

    Monocular scale: pair k's unit-norm translation is rescaled so that
    landmarks of the shared middle frame agree in depth with pair k-1
    (median depth ratio over common keypoints). Pass precomputed ``feats``
    (from compute_features) to avoid re-extracting.

    Scale backbone (``cfg.auto_stride``): when the consecutive-frame
    parallax (≈ 1/median-landmark-depth at unit baseline) is below
    ``cfg.target_parallax``, a second batched pass estimates strided
    wider-baseline pairs; monocular scale chains over the backbone (N/s
    compounding steps of far less depth noise) and each segment's
    consecutive estimates are rescaled to the backbone's baseline, with
    endpoint discrepancies distributed linearly — keyframe-to-frame
    tracking the way production monocular systems survive high frame
    rates, built from the same batched pair program.

    ``key`` is the draw source (DeviceDraws(0) on the device when None);
    ``device`` defaults to the model's (cuda without a model).
    """
    cfg = cfg or SlamConfig()
    device = _resolve_device(device, model)
    if key is None:
        key = DeviceDraws(0, device)
    # dedicated subkeys up front: batched_pair_poses consumes its key via
    # split(key, n_pairs), and threefry split(key, 2) equals the first two
    # of split(key, n) — re-splitting the consumed key downstream would
    # correlate the skip-pair RANSAC stream with chain pair index 1
    key, k_bb, k_chain, k_skip = key.split(4)
    if feats is None:
        feats = compute_features(frames, model, cfg)

    n_kp = feats[0][1].shape[0]
    n_frames = len(feats)
    pair_idx = [(i, i + 1) for i in range(n_frames - 1)]
    pairs, usable = batched_pair_poses(feats, pair_idx, intrinsics, cfg,
                                       k_chain, device=device)
    for i, u in enumerate(usable):
        if not u:
            raise ValueError(
                f"too few matches between frames {i} and {i + 1}: "
                f"{pairs[i].kp_prev_idx.size}")

    # pick the scale-backbone stride from measured parallax: landmark
    # depths are in unit-baseline units, so parallax ≈ 1/median-depth
    stride = 1
    if cfg.auto_stride:
        meds = [float(np.median(est.points3d[:, 2]))
                for est in pairs if est.points3d.shape[0] >= 8]
        # the node floor must not force stride 1 on a short low-parallax
        # sequence (the consecutive chain's translation directions are
        # exactly what the backbone exists to fix): cap the floor at half
        # the frames so stride 2 stays reachable whenever parallax asks —
        # but keep >= 16 nodes, below which the back end (loop retrieval,
        # windowed BA) has too little graph to work with and very short
        # sequences are better served by the consecutive chain
        min_nodes = max(16, min(cfg.min_backbone_nodes, n_frames // 2))
        stride_cap = max(1, min(cfg.max_stride, (n_frames - 1) // 2,
                                n_frames // min_nodes))
        if meds:
            med_depth = float(np.median(meds))
            stride = int(np.clip(np.ceil(med_depth * cfg.target_parallax),
                                 1, stride_cap))

    def estimate_backbone(s, key):
        nodes = list(range(0, n_frames, s))
        if nodes[-1] != n_frames - 1:
            nodes.append(n_frames - 1)
        idx = list(zip(nodes[:-1], nodes[1:]))
        bbp, ok = batched_pair_poses(feats, idx, intrinsics, cfg, key,
                                     device=device)
        return idx, bbp, all(ok)

    if stride > 1:
        bb_idx, bb_pairs, bb_ok = estimate_backbone(stride, k_bb)
        if not bb_ok:
            stride = 1  # weak overlap at this stride: consecutive fallback
        else:
            # self-correcting refinement: the consecutive-pair depths that
            # chose the stride are themselves noise-biased at very low
            # parallax (the reason the backbone exists), so re-measure
            # parallax on the BACKBONE pairs — whose wide baselines give
            # trustworthy depths — and widen the stride until the measured
            # per-step parallax reaches the target (high-frame-rate / long
            # sequences otherwise saturate the first estimate)
            for _ in range(2):
                meds_bb = [float(np.median(e.points3d[:, 2]))
                           for e in bb_pairs if e.points3d.shape[0] >= 8]
                if not meds_bb:
                    break
                want = int(np.ceil(stride * float(np.median(meds_bb))
                                   * cfg.target_parallax))
                want = min(want, stride_cap)
                if want <= stride:
                    break
                key, k_bb = k_bb.split(2)
                idx2, bbp2, ok2 = estimate_backbone(want, key)
                if not ok2:
                    break  # keep the last stride that fully matched
                stride, bb_idx, bb_pairs = want, idx2, bbp2

    if stride == 1:
        frame_ids = list(range(n_frames))
        raw_skips, raw_ok = [], []
        plain_hops = None
        if cfg.odo_redundant and n_frames >= 4:
            plain_hops = _plain_hop_lengths(pairs, n_kp,
                                            cfg.min_scale_points,
                                            cfg.odo_vel_window,
                                            cfg.odo_vel_clamp)
            raw_skips, raw_ok = _skip_pair_estimates(
                feats, frame_ids, intrinsics, cfg, k_skip, device=device)
            _triangle_flip_repair(pairs, raw_skips, raw_ok, feats,
                                  frame_ids, intrinsics, cfg, device=device)
        _chain_scales(pairs, n_kp, cfg.min_scale_points,
                      cfg.odo_vel_window, cfg.odo_vel_clamp)
        if raw_skips and cfg.odo_scale_refine:
            _skip_scale_refine(pairs, raw_skips, raw_ok, cfg, n_kp)
        rs, ts = _chain_poses(pairs)
        rs, ts = np.stack(rs), np.stack(ts)
        skip_edges = None
        if raw_skips:
            skip_edges = _gate_skip_edges(raw_skips, raw_ok, pairs, ts,
                                          cfg, n_kp) or None
            if skip_edges:
                rs, ts = _fuse_redundant_chain(rs, ts, pairs,
                                               skip_edges, cfg, device=device)
        return SlamResult(rotations=rs, translations=ts, pairs=pairs,
                          skip_edges=skip_edges, plain_hops=plain_hops)

    nodes = np.asarray([a for a, _ in bb_idx] + [bb_idx[-1][1]], int)

    # redundant stride-2s skip estimates: first repair direction-flipped
    # backbone edges (scale-free triangle test, BEFORE the scale chain
    # votes through their junk landmarks), then fuse the surviving skip
    # edges so no single noisy backbone edge owns the trajectory
    raw_skips, raw_ok = [], []
    plain_hops = None
    if cfg.odo_redundant and len(nodes) >= 4:
        plain_hops = _plain_hop_lengths(bb_pairs, n_kp,
                                        cfg.min_scale_points,
                                        cfg.odo_vel_window,
                                        cfg.odo_vel_clamp)
        raw_skips, raw_ok = _skip_pair_estimates(
            feats, nodes, intrinsics, cfg, k_skip, device=device)
        _triangle_flip_repair(bb_pairs, raw_skips, raw_ok, feats, nodes,
                              intrinsics, cfg, device=device)

    # scale chaining over the backbone, then absolute backbone poses
    _chain_scales(bb_pairs, n_kp, cfg.min_scale_points,
                  cfg.odo_vel_window, cfg.odo_vel_clamp)
    if raw_skips and cfg.odo_scale_refine:
        _skip_scale_refine(bb_pairs, raw_skips, raw_ok, cfg, n_kp)
    rs_bb, ts_bb = _chain_poses(bb_pairs)
    rs_bb, ts_bb = np.stack(rs_bb), np.stack(ts_bb)

    skip_edges = None
    if raw_skips:
        skip_edges = _gate_skip_edges(raw_skips, raw_ok, bb_pairs, ts_bb,
                                      cfg, n_kp) or None
        if skip_edges:
            rs_bb, ts_bb = _fuse_redundant_chain(rs_bb, ts_bb, bb_pairs,
                                                 skip_edges, cfg,
                                                 device=device)

    # rescale each segment's consecutive estimates to backbone units
    # (downstream consumers — keyframing, loop-closure scale maps,
    # pose-graph edges — all read pairs[...] in trajectory scale)
    for k, (a, b) in enumerate(bb_idx):
        seg = pairs[a:b]
        lr, lt = _chain_poses(seg)
        est_bb = bb_pairs[k]
        t_ab = -est_bb.rotation.T @ est_bb.translation
        chain_len = float(np.linalg.norm(lt[-1]))
        alpha = (float(np.linalg.norm(t_ab)) / chain_len
                 if chain_len > 1e-9 else 1.0)
        for est in seg:
            est.translation = est.translation * alpha
            est.points3d = est.points3d * alpha
    rs_all, ts_all = _hang_intermediates(rs_bb, ts_bb, nodes, pairs)
    return SlamResult(rotations=rs_all, translations=ts_all, pairs=pairs,
                      nodes=nodes, bb_pairs=bb_pairs, skip_edges=skip_edges,
                      plain_hops=plain_hops)


def _hang_intermediates(rs_nodes, ts_nodes, nodes: np.ndarray,
                        pairs: Sequence[PairEstimate]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """All-frame trajectory from node poses + consecutive estimates.

    Within each backbone segment the (already backbone-rescaled)
    consecutive chain is re-anchored to the node endpoints: one scalar
    rescale to match the node baseline, endpoint discrepancy distributed
    linearly over the segment. Used both at odometry time and to re-hang
    frames after the node-level pose-graph solve."""
    n_frames = int(nodes[-1]) + 1
    rs_all = [None] * n_frames
    ts_all = [None] * n_frames
    for k in range(len(nodes) - 1):
        a, b = int(nodes[k]), int(nodes[k + 1])
        rs_all[a], ts_all[a] = rs_nodes[k], ts_nodes[k]
        rs_all[b], ts_all[b] = rs_nodes[k + 1], ts_nodes[k + 1]
        seg = pairs[a:b]
        lr, lt = _chain_poses(seg)
        # frame-b offset in frame-a coords per the node poses
        t_ab = rs_nodes[k].T @ (ts_nodes[k + 1] - ts_nodes[k])
        chain_len = float(np.linalg.norm(lt[-1]))
        alpha = (float(np.linalg.norm(t_ab)) / chain_len
                 if chain_len > 1e-9 else 1.0)
        d = t_ab - alpha * lt[-1]
        n_seg = len(seg)
        for m in range(1, n_seg):
            pos = alpha * lt[m] + (m / n_seg) * d
            rs_all[a + m] = rs_all[a] @ lr[m]
            ts_all[a + m] = rs_all[a] @ pos + ts_all[a]
    return np.stack(rs_all), np.stack(ts_all)


def select_keyframes(result: SlamResult, cfg: SlamConfig) -> np.ndarray:
    """Motion-based keyframe promotion: a frame becomes a keyframe when the
    accumulated rotation angle or translation since the last keyframe
    exceeds the config thresholds. Frames 0 and F-1 are always keyframes."""
    n = result.rotations.shape[0]
    kf = [0]
    rots = np.stack([est.rotation for est in result.pairs])
    cos = np.clip((np.trace(rots, axis1=1, axis2=2) - 1.0) * 0.5, -1.0, 1.0)
    angles = np.arccos(cos)  # = |so3_log(R)|, no device round-trips
    # decoupling: under redundant-edge repair, accumulate the PLAIN
    # chain's hop lengths so the keyframe set does not move with the
    # repair (see SlamResult.plain_hops)
    hops = (result.plain_hops
            if (result.plain_hops is not None
                and len(result.plain_hops) == len(result.pairs))
            else np.asarray([float(np.linalg.norm(est.translation))
                             for est in result.pairs]))
    acc_rot, acc_tr = 0.0, 0.0
    for k, est in enumerate(result.pairs):
        acc_rot += float(angles[k])
        acc_tr += float(hops[k])
        if acc_rot >= cfg.kf_min_rotation or acc_tr >= cfg.kf_min_translation:
            kf.append(k + 1)
            acc_rot, acc_tr = 0.0, 0.0
    if kf[-1] != n - 1:
        kf.append(n - 1)
    return np.asarray(kf, int)


def _global_descriptors(feats) -> np.ndarray:
    """L2-normalised mean of the valid local descriptors per frame — the
    retrieval representation (pipeline/eval.py retrieval protocol)."""
    out = []
    for yx, desc, valid in feats:
        d = desc[valid]
        g = d.mean(0) if len(d) else np.zeros(desc.shape[1], desc.dtype)
        out.append(g / (np.linalg.norm(g) + 1e-12))
    return np.stack(out)


def detect_loop_closures(feats, keyframes: np.ndarray, result: SlamResult,
                         intrinsics, cfg: SlamConfig,
                         key=None, stats: Optional[dict] = None,
                         device="cuda",
                         ) -> List[Tuple[int, int, np.ndarray, np.ndarray]]:
    """Find loop closures among keyframes: retrieval + geometric verify.

    Returns pose-graph edges (i, j, R_ij, t_ij) with i < j and the
    measurement in the i_T_j convention of geometry/posegraph.py. Monocular
    translation scale is recovered by depth-ratio voting against the
    odometry landmarks of frame i; candidate pairs whose scale cannot be
    established are dropped (a mis-scaled loop edge is worse than none).

    ``stats``: optional dict filled with per-gate rejection counters
    (n_candidates, rej_inliers, rej_ratio, rej_vote_b, rej_vote_a,
    rej_scale, rej_path, accepted, deduped) — the seed-robustness study's
    instrument (tools/slam_study.py).
    """
    if key is None:
        key = DeviceDraws(1, device)
    kfs = np.asarray([int(k) for k in keyframes], int)
    n_kf = len(kfs)
    g = _global_descriptors([feats[k] for k in kfs])
    sims = g @ g.T
    n_kp = feats[0][1].shape[0]

    # retrieval, fully vectorised (the O(K^2) host loop was the KITTI-scale
    # back-end bottleneck): allowed[a, b] = keyframe b is old enough to be a
    # loop partner of a; candidates = per-row top-k over allowed partners,
    # optionally intersected with the per-COLUMN top-k (mutual retrieval
    # consistency — b must also rank a among its best future frames, which
    # kills one-sided similarity hits on repetitive structure)
    allowed = (kfs[:, None] - kfs[None, :]) >= cfg.loop_gap
    allowed &= kfs[None, :] < len(result.pairs)  # need odometry depths at b
    k_ret = min(cfg.loop_top_k, max(n_kf - 1, 1))
    masked = np.where(allowed, sims, -np.inf)
    in_top_back = np.zeros_like(allowed)
    rows = np.argpartition(-masked, kth=k_ret - 1, axis=1)[:, :k_ret]
    in_top_back[np.arange(n_kf)[:, None], rows] = True
    in_top_back &= allowed
    if cfg.loop_mutual:
        in_top_fwd = np.zeros_like(allowed)
        cols = np.argpartition(-masked, kth=k_ret - 1, axis=0)[:k_ret, :]
        in_top_fwd[cols, np.arange(n_kf)[None, :]] = True
        in_top_back &= in_top_fwd
    a_pos, b_pos = np.nonzero(in_top_back)
    cand = [(int(kfs[b]), int(kfs[a])) for a, b in zip(a_pos, b_pos)]

    ests, usable = batched_pair_poses(feats, cand, intrinsics, cfg, key,
                                      device=device)
    if stats is None:
        stats = {}
    stats.update(n_candidates=len(cand), rej_inliers=0, rej_ratio=0,
                 rej_vote_b=0, rej_vote_a=0, rej_scale=0, rej_path=0,
                 rej_vote_b_count=0, rej_vote_b_mad=0,
                 rej_vote_a_count=0, rej_vote_a_mad=0,
                 rescued_vote_b=0, rescued_vote_a=0, sim3_rescued=0,
                 weak_vote_b=0, weak_vote_a=0,
                 accepted=0, deduped=0)
    min_votes = max(cfg.min_scale_points, cfg.loop_min_vote_points)

    def _gated_vote(f: int, kp_idx, pts,
                    tag: str) -> Tuple[Optional[float], bool]:
        """Depth-ratio scale vote at frame f -> (scale | None, weak).

        Forward-pair depths first (bit-identical to the round-2
        committed behaviour whenever it passes); on failure retry ONCE
        against the merged forward+backward map (_endpoint_depths) —
        same gates, wider vote pool — and count the rescue. A vote whose
        MAD fails the strict gate but stays under loop_vote_weak_mad is
        returned with weak=True (see SlamConfig.loop_vote_weak_mad: the
        caller demands a strong-revisit path margin for such edges)."""
        odo = result.pairs[f]
        depths = _depth_map(odo.kp_prev_idx, odo.points3d[:, 2], n_kp)
        scale, _, mad = _depth_ratio_stats(depths, kp_idx, pts, min_votes)
        bad_mad = cfg.loop_vote_max_mad > 0 and mad > cfg.loop_vote_max_mad
        if (scale is None or bad_mad) and cfg.loop_vote_merge:
            merged = _endpoint_depths(result.pairs, n_kp, f)
            scale, _, mad = _depth_ratio_stats(merged, kp_idx, pts,
                                               min_votes)
            bad_mad = (cfg.loop_vote_max_mad > 0
                       and mad > cfg.loop_vote_max_mad)
            if scale is not None and not bad_mad:
                stats[f"rescued_{tag}"] += 1
        if scale is not None and bad_mad and (
                cfg.loop_vote_weak_mad > 0
                and mad <= cfg.loop_vote_weak_mad):
            stats[f"weak_{tag}"] += 1
            return scale, True
        if scale is None or bad_mad:
            stats[f"rej_{tag}_count" if scale is None
                  else f"rej_{tag}_mad"] += 1
            stats[f"rej_{tag}"] += 1
            return None, False
        return scale, False
    # odometry path length between two frames, in propagated-scale units —
    # the denominator of the self-scaling re-visit test below
    step_len = np.asarray([float(np.linalg.norm(p.translation))
                           for p in result.pairs])
    cum_len = np.concatenate([[0.0], np.cumsum(step_len)])
    accepted = []
    for (fb, fa), est, u in zip(cand, ests, usable):
        if not u or est.n_inliers < cfg.loop_min_inliers:
            stats["rej_inliers"] += 1
            continue
        # inlier RATIO gate: a wide-baseline candidate can reach the
        # absolute inlier count on sheer match volume while most matches
        # are wrong — those are exactly the scale-poisoned edges
        if est.n_inliers < cfg.loop_min_inlier_ratio * max(est.n_matches, 1):
            stats["rej_ratio"] += 1
            continue
        # edge = (direct_hop_len, R, t, s_z, weak) in frame-fb units,
        # from whichever measurement path survives its gates
        edge = None
        # scale: est.points3d live in frame-fb coords with unit-baseline
        # scale; compare with the odometry landmark depths of pair
        # (fb, fb+1), which are scale-propagated and also frame-fb.
        scale, weak_b = _gated_vote(fb, est.kp_prev_idx, est.points3d,
                                    "vote_b")
        if scale is not None:
            # second, independent vote at the OTHER endpoint: the same
            # loop landmarks expressed in frame fa vs the odometry depths
            # of pair (fa, fa+1). Under monocular drift the two votes
            # measure the SAME baseline in the two endpoints' LOCAL map
            # units, so their ratio is the accumulated relative scale
            # drift between the endpoints — the Sim(3) edge's scale
            # measurement (ORB-SLAM's Sim(3) closure transform), NOT
            # noise to be gated away. Round 2's tight agreement gate
            # rejected exactly the drift-carrying TRUE closures the graph
            # needs most; only a loose sanity bound remains for the
            # Sim(3) path, while SE(3) graphs (which cannot absorb a
            # scale mismatch) keep the tight gate + geometric-mean
            # compromise.
            vote_ok, s_z, weak = True, 1.0, weak_b
            if fa < len(result.pairs):
                pts_fa = est.points3d @ est.rotation.T + est.translation
                scale_a, weak_a = _gated_vote(fa, est.kp_next_idx, pts_fa,
                                              "vote_a")
                if scale_a is None:
                    vote_ok = False
                else:
                    weak = weak_b or weak_a
                    ratio = max(scale_a, scale) / min(scale_a, scale)
                    if cfg.use_sim3:
                        if ratio > cfg.loop_scale_sanity:
                            stats["rej_scale"] += 1
                            vote_ok = False
                        else:  # zero-residual convention
                            s_z = float(scale / scale_a)
                    elif (cfg.loop_scale_consistency > 0
                            and ratio > cfg.loop_scale_consistency):
                        stats["rej_scale"] += 1
                        vote_ok = False
                    else:
                        scale = float(np.sqrt(scale_a * scale))
            if vote_ok:
                # est maps frame-fb -> frame-fa; the edge measurement is
                # i_T_j = inv([R | s*t]) with i=fb, j=fa.
                r_inv = est.rotation.T
                t_inv = -r_inv @ (est.translation * scale)
                edge = (scale * float(np.linalg.norm(est.translation)),
                        r_inv, t_inv, s_z, weak)
        if edge is None and cfg.use_sim3 and cfg.loop_sim3_fallback:
            # vote path failed -> Sim(3) map alignment (see
            # _sim3_from_landmarks): odometry landmarks at both
            # endpoints, loop pair supplies correspondences only. Its
            # (s, R, t) IS the i_T_j closure (X_b = s R X_a + t maps
            # frame-fa coords into frame-fb), gated on alignment quality
            # and agreement with the essential-matrix rotation.
            z_b = _endpoint_depths(result.pairs, n_kp, fb)
            z_a = _endpoint_depths(result.pairs, n_kp, fa)
            horn = _sim3_from_landmarks(
                feats[fb][0], feats[fa][0], z_b, z_a,
                est.kp_prev_idx, est.kp_next_idx, intrinsics, min_votes)
            if horn is not None:
                s_h, r_h, t_h, _, rel = horn
                # r_h: fa->fb, est.rotation: fb->fa — product ~ identity
                rot_err = float(np.arccos(np.clip(
                    (np.trace(r_h @ est.rotation) - 1.0) / 2.0, -1, 1)))
                if (rel <= cfg.loop_sim3_max_res and s_h > 0
                        and max(s_h, 1.0 / s_h) <= cfg.loop_scale_sanity
                        and rot_err <= cfg.loop_sim3_max_rot):
                    # translation here comes from noisy depth maps:
                    # admit only as a strong revisit (weak=True)
                    edge = (float(np.linalg.norm(t_h)), r_h, t_h,
                            float(s_h), True)
                    stats["sim3_rescued"] += 1
        if edge is None:
            continue
        direct, r_e, t_e, s_e, weak_edge = edge
        # re-visit test (self-scaling, replaces any fixed frame-gap
        # heuristic): a loop closure is a SHORT direct hop between frames
        # whose odometry path is LONG — co-visible near-neighbours have
        # direct ~ path and are odometry, not loops. Both lengths are in
        # drift-consistent local units (direct is in frame-fb units; the
        # path starts at fb), so the test survives arbitrary global
        # drift.
        # weak edges (MAD-failing votes / map-alignment translations)
        # must show overwhelming geometric consensus AND clear the much
        # tighter strong-revisit margin
        if weak_edge and est.n_inliers < (cfg.loop_weak_min_inlier_ratio
                                          * max(est.n_matches, 1)):
            stats["rej_ratio"] += 1
            continue
        limit = (cfg.loop_weak_path_ratio if weak_edge
                 else cfg.loop_path_ratio)
        if limit > 0:
            path = float(cum_len[min(fa, len(step_len))] - cum_len[fb])
            if direct >= limit * path:
                stats["rej_path"] += 1
                continue
        accepted.append((est.n_inliers, fb, fa, r_e, t_e, s_e))

    # temporal-cluster dedup: consecutive keyframes revisiting the same
    # place produce a blanket of near-duplicate edges (229 on the 192-frame
    # bench); each carries independent scale-voting noise, and their sheer
    # count out-votes the odometry in the graph. Keep the strongest edge
    # per (i, j) neighbourhood.
    radius = cfg.loop_cluster_frames or max(1, cfg.loop_gap // 2)
    accepted.sort(key=lambda e: -e[0])
    stats["accepted"] = len(accepted)
    edges: List[Tuple[int, int, np.ndarray, np.ndarray, float]] = []
    for n_inl, fb, fa, r_e, t_e, s_e in accepted:
        if any(abs(fb - i) <= radius and abs(fa - j) <= radius
               for i, j, *_ in edges):
            stats["deduped"] += 1
            continue
        edges.append((fb, fa, r_e, t_e, s_e))
    return edges


def build_tracks(pairs: Sequence[PairEstimate]) -> List[List[Tuple[int, int]]]:
    """Chain pairwise inlier correspondences into multi-frame tracks.

    Each track is a list of (frame, keypoint) observations; consecutive
    pairs sharing a keypoint extend the same track (forward chaining, the
    union-find degenerates to this because matches are frame-to-next)."""
    active: Dict[int, List[Tuple[int, int]]] = {}
    tracks: List[List[Tuple[int, int]]] = []
    for k, est in enumerate(pairs):
        new_active: Dict[int, List[Tuple[int, int]]] = {}
        for kp_i, kp_j in zip(est.kp_prev_idx, est.kp_next_idx):
            tr = active.pop(int(kp_i), None)
            if tr is None:
                tr = [(k, int(kp_i))]
                tracks.append(tr)
            tr.append((k + 1, int(kp_j)))
            new_active[int(kp_j)] = tr
        active = new_active
    return tracks


def _tracks_to_arrays(tracks: List[List[Tuple[int, int]]]):
    """Ragged track list -> (starts, lens, offs, kps) numpy arrays.

    build_tracks produces frame-CONTIGUOUS tracks (an observation at frame
    f is only ever extended at f+1), so a track is fully described by its
    start frame + its keypoint sequence — window clipping then becomes
    interval intersection instead of a per-(window, track) Python scan."""
    starts = np.asarray([tr[0][0] for tr in tracks], np.int64)
    lens = np.asarray([len(tr) for tr in tracks], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    kps = np.asarray([kp for tr in tracks for _, kp in tr], np.int64)
    return starts, lens, offs, kps


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[3, 2] -> [0, 1, 2, 0, 1] (the standard cumsum trick)."""
    total = int(counts.sum())
    out = np.arange(total)
    resets = np.repeat(np.concatenate([[0], np.cumsum(counts[:-1])]), counts)
    return out - resets


def _extrinsics(result: SlamResult, frame: int):
    """world_T_frame -> (R, t) with x_cam = R x_world + t."""
    rw = result.rotations[frame]
    tw = result.translations[frame]
    return rw.T, -rw.T @ tw


def windowed_ba(result: SlamResult, feats, intrinsics, cfg: SlamConfig,
                device="cuda",
                mesh=None) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Refine local geometry per window with multi-view BA; return refined
    odometry edge measurements {k: (R, t)} = i_T_j for edge (k, k+1).

    Architecture note: instead of splicing window poses into the global
    trajectory (which would need gauge bookkeeping per overlap), each
    window's BA result is read back as *relative* consecutive-pose
    measurements that replace the two-view odometry edges in the final
    pose-graph solve — the local-BA + pose-graph split of modern monocular
    systems.

    Each window solves on ``device`` as its own problem (the reference
    pads windows into shape buckets and vmaps each bucket; padding
    observations carry weight 0 and padding landmarks no observation of
    weight, so the per-window result is the same without them).

    With ``mesh``, windows are dealt to the dp ranks in a fixed order
    (window i to dp rank i mod dp: map blocks per host, the JAX package's
    dp split of its vmapped window batch); each rank solves its windows
    and one all_gather over dp shares the refined edges, applied in window
    order as on one device.

    Measured caveat (reference): on LOW-PARALLAX consecutive frames the
    window BA converges to sub-pixel reprojection yet its relative
    translation DIRECTIONS are no better than the two-view estimates; the
    scale backbone of run_odometry routes such sequences to strided node
    pairs, so this function sees wide-baseline trajectories.
    """
    fx, fy, cx, cy = intrinsics
    n_frames = result.rotations.shape[0]
    if cfg.ba_window < 3 or n_frames < 3:
        return {}
    dev = torch.device(device)
    tracks = build_tracks(result.pairs)
    tr_start, tr_len, tr_off, tr_kps = _tracks_to_arrays(tracks)
    edges: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    by_window: Dict[int, list] = {}

    starts = list(range(0, max(1, n_frames - 2), cfg.ba_stride))
    n_dp, dp_idx = ((mesh.shape["dp"], mesh.axis_index("dp"))
                    if mesh is not None else (1, 0))
    for wi, a in enumerate(starts):
        if wi % n_dp != dp_idx:
            continue                    # another dp rank's window
        b = min(a + cfg.ba_window, n_frames)
        if b - a < 3:
            continue
        m = b - a
        # tracks clipped to [a, b): interval intersection on the contiguous
        # frame ranges, longest first
        c_lo = np.maximum(tr_start, a)
        c_hi = np.minimum(tr_start + tr_len, b)
        c_len = c_hi - c_lo
        sel = np.nonzero(c_len >= 2)[0]
        sel = sel[np.argsort(-c_len[sel], kind="stable")][:cfg.ba_max_tracks]
        if sel.size < 8:
            continue
        cl = c_len[sel]
        base = tr_off[sel] + (c_lo[sel] - tr_start[sel])

        r_cam = np.stack([_extrinsics(result, f)[0] for f in range(a, b)])
        t_cam = np.stack([_extrinsics(result, f)[1] for f in range(a, b)])
        yx_win = np.stack([feats[f][0] for f in range(a, b)])  # (m, K, 2)

        def obs_uv_arr(f_arr, kp_arr):
            yx = yx_win[f_arr, kp_arr]
            return np.stack([(yx[..., 1] - cx) / fx,
                             (yx[..., 0] - cy) / fy], -1).astype(np.float32)

        # seed triangulation of every track from its first/last observation,
        # batched over the window's tracks
        f0s = c_lo[sel] - a
        kp0s = tr_kps[base]
        f1s = c_hi[sel] - 1 - a
        kp1s = tr_kps[base + cl - 1]
        r_rel = r_cam[f1s] @ r_cam[f0s].transpose(0, 2, 1)
        t_rel = t_cam[f1s] - np.einsum("nij,nj->ni", r_rel, t_cam[f0s])
        r_t, t_t, x0, x1 = _f32(dev, r_rel, t_rel, obs_uv_arr(f0s, kp0s),
                                obs_uv_arr(f1s, kp1s))
        p_rel = triangulate_points(r_t, t_t, x0[:, None],
                                   x1[:, None])[:, 0].cpu().numpy()
        # frame-f0 coords -> world
        rot_w = result.rotations[f0s + a]
        points0 = (np.einsum("nij,nj->ni", rot_w, p_rel)
                   + result.translations[f0s + a])

        # flat observation table, ragged-range expansion over the clips
        rag = _ragged_arange(cl)
        cam_idx = np.repeat(f0s, cl) + rag                 # window-local
        pt_idx = np.repeat(np.arange(sel.size), cl)
        obs_kp = tr_kps[np.repeat(base, cl) + rag]
        uvs = obs_uv_arr(cam_idx, obs_kp)
        # a track observes each window frame at most once: width <= m
        table, _ = build_landmark_table(pt_idx, len(points0), max_obs=m)
        out = multi_view_ba(
            *_f32(dev, r_cam, t_cam, points0), *_i64(dev, cam_idx, pt_idx),
            *_f32(dev, uvs), table, n_iters=cfg.ba_window_iters)
        costs = out.cost_history.cpu().numpy()
        if not np.isfinite(costs[-1]) or costs[-1] > costs[0]:
            continue  # keep the two-view edges for this window
        r_ba = out.r.cpu().numpy()
        t_ba = out.t.cpu().numpy()
        r_cam = r_cam.astype(np.float32)
        t_cam = t_cam.astype(np.float32)
        # world_T_f = inv(extrinsic); edge Z_{k,k+1} = T_k^-1 T_{k+1}
        rel = []
        for k in range(m - 1):
            # T_k^-1 T_{k+1} in world_T convention equals
            # extr_k o inv(extr_{k+1})
            r_z = r_ba[k] @ r_ba[k + 1].T
            t_z = t_ba[k] - r_z @ t_ba[k + 1]
            rel.append((r_z, t_z))
        # monocular scale-gauge anchor: BA's reduced system is singular
        # along global scale (the LM damping lets it drift per window);
        # re-anchor so the window's total baseline matches the input
        # trajectory's (shape is BA's to refine, scale is not)
        base_in = sum(
            float(np.linalg.norm(t_cam[k + 1]
                                 - (r_cam[k + 1] @ r_cam[k].T)
                                 @ t_cam[k]))
            for k in range(m - 1))
        base_ba = sum(float(np.linalg.norm(t)) for _, t in rel)
        s = base_in / base_ba if base_ba > 1e-12 else 1.0
        by_window[wi] = [(r_z, t_z * s) for r_z, t_z in rel]
    if mesh is not None:
        by_window = _gather_windows(mesh, by_window, len(starts),
                                    cfg.ba_window - 1)
    for wi in sorted(by_window):
        for k, edge in enumerate(by_window[wi]):
            edges[starts[wi] + k] = edge
    return edges


def _gather_windows(mesh, by_window, n_windows: int, max_edges: int):
    """Every dp rank's refined window edges on every rank: one all_gather
    over dp of an (n_windows, 1 + 12 max_edges) table per rank (the edge
    count, then each edge's R and t; f64 holds the f32 values exactly),
    each window read from its owner's table."""
    n_dp = mesh.shape["dp"]
    table = np.zeros((n_windows, 1 + 12 * max_edges))
    for wi, rel in by_window.items():
        table[wi, 0] = len(rel)
        for k, (r_z, t_z) in enumerate(rel):
            table[wi, 1 + 12 * k:13 + 12 * k] = np.concatenate(
                [np.ravel(r_z), t_z])
    every = mesh.all_gather(
        torch.from_numpy(table).to(mesh.device), "dp").cpu().numpy()
    out = {}
    for wi in range(n_windows):
        row = every[(wi % n_dp) * n_windows + wi]
        if row[0]:
            out[wi] = [(row[1 + 12 * k:10 + 12 * k].reshape(3, 3)
                        .astype(np.float32),
                        row[10 + 12 * k:13 + 12 * k].astype(np.float32))
                       for k in range(int(row[0]))]
    return out


def _loop_edge_chi2(result: SlamResult, loop_edges, loop_weight: float
                    ) -> np.ndarray:
    """Initial per-loop-edge chi² against the current trajectory (host
    numpy; small-angle se3_log approximation — this only calibrates the
    robust kernel width, it is not the solver's residual)."""
    chi2 = []
    for edge in loop_edges:
        i, j, r_ij, t_ij = edge[:4]
        s_ij = float(edge[4]) if len(edge) > 4 else 1.0
        ri, ti = result.rotations[i], result.translations[i]
        rj, tj = result.rotations[j], result.translations[j]
        r_rel = ri.T @ rj
        t_rel = ri.T @ (tj - ti)
        err_r = np.asarray(r_ij).T @ r_rel
        err_t = (np.asarray(r_ij).T @ (t_rel - np.asarray(t_ij))) / s_ij
        ang = np.arccos(np.clip((np.trace(err_r) - 1.0) * 0.5, -1.0, 1.0))
        chi2.append(loop_weight * (float(err_t @ err_t) + float(ang) ** 2))
    return np.asarray(chi2)


def refine_with_pose_graph(result: SlamResult,
                           loop_edges: Optional[List[Tuple[int, int, np.ndarray, np.ndarray]]] = None,
                           odometry_overrides: Optional[Dict[int, Tuple[np.ndarray, np.ndarray]]] = None,
                           loop_weight: float = 1.0,
                           n_iters: int = 15,
                           sim3: bool = False,
                           robust: str = "none",
                           robust_scale: float = 4.0,
                           gnc_iters: int = 8,
                           extra_edges=None,
                           extra_weight: float = 1.0,
                           device="cuda", mesh=None) -> SlamResult:
    """Pose-graph polish on ``device``: odometry edges from the chained
    pairs (optionally overridden by windowed-BA refinements) plus
    (i, j, R_ij, t_ij[, s_ij]) loop closures. ``sim3=True`` optimises over
    Sim(3) — per-node scale states absorb monocular scale drift, which
    SE(3) edges structurally cannot (use whenever loop closures are
    present). With ``mesh``, the edges split over the dp axis and the
    normal system is summed by one all_reduce per LM iteration (the
    distributed back end of BASELINE config 5).

    ``robust``: edge-level robust kernel ("huber"/"dcs") engaged only when
    loop edges are present. Its width is calibrated on the LOOP edges'
    initial chi² (median × ``robust_scale``): odometry residuals are ~0 at
    the chained init, so a whole-graph median would crush every loop edge
    to zero weight and the graph would ignore its own closures."""
    ei, ej, rz, tz, sz, wts = [], [], [], [], [], []
    overrides = odometry_overrides or {}
    for k, est in enumerate(result.pairs):
        if k in overrides:
            r_e, t_e = overrides[k]
        else:
            # edge measurement i_T_j with j = k+1: inv([R|t])
            r_e = est.rotation.T
            t_e = -r_e @ est.translation
        ei.append(k)
        ej.append(k + 1)
        rz.append(r_e)
        tz.append(t_e)
        sz.append(1.0)
        wts.append(1.0)
    # redundant odometry-class edges (skip edges from run_odometry):
    # same trajectory scale as the chain (s_z = 1), excluded from the
    # robust-kernel calibration, which reads loop edges only
    for i, j, r_e, t_e in extra_edges or []:
        ei.append(int(i))
        ej.append(int(j))
        rz.append(np.asarray(r_e))
        tz.append(np.asarray(t_e))
        sz.append(1.0)
        wts.append(extra_weight)
    for edge in loop_edges or []:
        i, j, r_ij, t_ij = edge[:4]
        ei.append(i)
        ej.append(j)
        rz.append(np.asarray(r_ij))
        tz.append(np.asarray(t_ij))
        # loop edges may carry a measured relative scale (the endpoint
        # depth-vote ratio — the Sim(3) drift signal); SE(3) solvers
        # ignore it (their detector path gated the ratio tight instead)
        sz.append(float(edge[4]) if len(edge) > 4 else 1.0)
        wts.append(loop_weight)
    robust_kwargs = {}
    if robust != "none" and loop_edges:
        chi2 = _loop_edge_chi2(result, loop_edges, loop_weight)
        delta2 = max(robust_scale * float(np.median(chi2)), 1e-8)
        robust_kwargs = dict(robust=robust,
                             robust_delta=float(np.sqrt(delta2)),
                             gnc_iters=min(gnc_iters, max(n_iters - 4, 0)))
    if mesh is not None:
        base = (optimize_pose_graph_sim3_sharded if sim3
                else optimize_pose_graph_sharded)

        def solver(*a, **kw):
            return base(mesh, *a, **kw)
    else:
        solver = optimize_pose_graph_sim3 if sim3 else optimize_pose_graph
    sim3_kwargs = {"s_z": _f32(device, sz)[0]} if sim3 else {}
    out = solver(
        *_f32(device, result.rotations, result.translations),
        *_i64(device, ei, ej),
        *_f32(device, np.stack(rz), np.stack(tz), wts),
        n_iters=n_iters, **sim3_kwargs, **robust_kwargs)
    return SlamResult(rotations=out.r.cpu().numpy(),
                      translations=out.t.cpu().numpy(), pairs=result.pairs,
                      keyframes=result.keyframes,
                      loop_edges=result.loop_edges)


def run_back_end(odo: SlamResult, feats, intrinsics, cfg: SlamConfig,
                 key=None, loop_stats: Optional[dict] = None,
                 device="cuda", mesh=None) -> SlamResult:
    """Keyframes -> loop detection -> windowed BA -> pose graph.

    When odometry produced a scale backbone, the WHOLE back end runs on
    the backbone nodes (the keyframe rate of a production system): node
    pairs carry the wide-baseline landmarks, loop scale voting reads
    their clean depths, windowed BA refines node poses, the pose graph
    solves over M = #nodes, and intermediate frames are re-hung off the
    optimized nodes — back-end cost scales with keyframes, not frames.
    With ``mesh``, windowed BA and the pose graph distribute over its dp
    axis (windowed_ba, refine_with_pose_graph); the rest runs on every
    rank.
    """
    if key is None:
        key = DeviceDraws(1, device)
    if odo.nodes is not None and len(odo.nodes) >= 4:
        nodes = odo.nodes
        stride = max(1, int(np.median(np.diff(nodes))))
        node_cfg = SlamConfig(**{**cfg.__dict__,
                                 "loop_gap": max(2, cfg.loop_gap // stride)})
        node_traj = SlamResult(
            rotations=odo.rotations[nodes],
            translations=odo.translations[nodes],
            pairs=odo.bb_pairs,
            plain_hops=odo.plain_hops)
        feats_n = [feats[int(n)] for n in nodes]
        kf_local = select_keyframes(node_traj, node_cfg)
        loops_n = detect_loop_closures(feats_n, kf_local, node_traj,
                                       intrinsics, node_cfg, key=key,
                                       stats=loop_stats, device=device)
        overrides = windowed_ba(node_traj, feats_n, intrinsics, node_cfg,
                                device=device, mesh=mesh)
        node_traj.keyframes = kf_local
        node_traj.loop_edges = loops_n
        sim3_n = cfg.use_sim3 and len(loops_n) > 0
        refined_n = refine_with_pose_graph(
            node_traj, loop_edges=loops_n, odometry_overrides=overrides,
            loop_weight=cfg.loop_weight, n_iters=cfg.pg_iters,
            sim3=sim3_n,
            robust=cfg.pg_robust, robust_scale=cfg.pg_robust_scale,
            gnc_iters=cfg.pg_gnc_iters,
            # redundant skip edges only stiffen an SE(3) polish; under a
            # Sim(3) loop solve they duplicate the odometry and resist
            # the very scale deformation the closures exist to apply
            # (measured: +0.03x span ATE on the 128-frame drift scene)
            extra_edges=None if sim3_n else odo.skip_edges,
            extra_weight=cfg.odo_skip_weight, device=device, mesh=mesh)
        rs_all, ts_all = _hang_intermediates(
            refined_n.rotations, refined_n.translations, nodes, odo.pairs)
        return SlamResult(
            rotations=rs_all, translations=ts_all, pairs=odo.pairs,
            keyframes=nodes[kf_local],
            loop_edges=[(int(nodes[i]), int(nodes[j]), r, t, s)
                        for i, j, r, t, s in loops_n],
            nodes=nodes, bb_pairs=odo.bb_pairs)

    kf = select_keyframes(odo, cfg)
    loops = detect_loop_closures(feats, kf, odo, intrinsics, cfg, key=key,
                                 stats=loop_stats, device=device)
    overrides = windowed_ba(odo, feats, intrinsics, cfg, device=device,
                            mesh=mesh)
    odo.keyframes = kf
    odo.loop_edges = loops
    sim3_f = cfg.use_sim3 and len(loops) > 0
    return refine_with_pose_graph(odo, loop_edges=loops,
                                  odometry_overrides=overrides,
                                  loop_weight=cfg.loop_weight,
                                  n_iters=cfg.pg_iters,
                                  sim3=sim3_f,
                                  robust=cfg.pg_robust,
                                  robust_scale=cfg.pg_robust_scale,
                                  gnc_iters=cfg.pg_gnc_iters,
                                  extra_edges=None if sim3_f
                                  else odo.skip_edges,
                                  extra_weight=cfg.odo_skip_weight,
                                  device=device, mesh=mesh)


def run_slam(frames, intrinsics, model: VGGDescriptor,
             cfg: Optional[SlamConfig] = None, key=None,
             device=None, mesh=None) -> SlamResult:
    """Full pipeline: odometry -> keyframes -> loop detection -> windowed
    BA -> pose graph. Returns the refined trajectory with the keyframe set
    and detected loop edges attached. Runs on the model's device unless
    ``device`` says otherwise; ``key`` is the draw source (DeviceDraws(0)
    on that device when None). With ``mesh``, every rank runs the front
    end and the back end distributes: BA windows over dp (map blocks per
    host) and the pose graph's edges over dp, its normal system summed by
    all_reduce (BASELINE config 5)."""
    cfg = cfg or SlamConfig()
    device = _resolve_device(device, model)
    if key is None:
        key = DeviceDraws(0, device)
    key, k_odo, k_back = key.split(3)
    feats = compute_features(frames, model, cfg)
    odo = run_odometry(frames, intrinsics, model, cfg, key=k_odo,
                       feats=feats, device=device)
    return run_back_end(odo, feats, intrinsics, cfg, key=k_back,
                        device=device, mesh=mesh)


def ate_rmse(traj: np.ndarray, gt: np.ndarray,
             with_scale: bool = True) -> float:
    """Umeyama-aligned absolute trajectory error (RMSE over positions)."""
    traj = np.asarray(traj, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_t, mu_g = traj.mean(0), gt.mean(0)
    xt, xg = traj - mu_t, gt - mu_g
    cov = xg.T @ xt / len(traj)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s[2, 2] = -1
    rot = u @ s @ vt
    if with_scale:
        var = (xt ** 2).sum() / len(traj)
        scale = np.trace(np.diag(d) @ s) / (var + 1e-12)
    else:
        scale = 1.0
    aligned = scale * xt @ rot.T + mu_g
    return float(np.sqrt(((aligned - gt) ** 2).sum(1).mean()))
