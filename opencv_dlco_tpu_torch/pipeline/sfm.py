"""Two-view structure-from-motion: the learned front end in one pass.

Port of ``opencv_dlco_tpu/pipeline/sfm.py`` (BASELINE.json config 4):
detect -> describe (learned VGG descriptor) -> 2-NN match (kernel F on
the card) + ratio test -> RANSAC essential -> cheirality pose recovery ->
triangulation -> Schur-complement two-view BA.

RANSAC's (ransac_iters, 8) sample table comes from ``draws``, a source with
``ransac_idx(hi, n_hyp, sample)`` (``pipeline/slam.DeviceDraws``, a seeded
generator on the device, unless the caller passes another), since torch
cannot reproduce ``jax.random`` streams.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry.ba import reprojection_residuals, two_view_ba
from ..geometry.epipolar import ransac_essential, recover_pose
from ..models.vgg import VGGDescriptor
from ..ops.detect import detect_corners, extract_patches
from ..ops.knn import knn_match, ratio_test
from .slam import DeviceDraws


@dataclass
class TwoViewResult:
    rotation: np.ndarray       # (3, 3) cam1 -> cam2
    translation: np.ndarray    # (3,) unit-scale
    points3d: np.ndarray       # (M, 3) in cam-1 frame (inlier matches)
    keypoints1: np.ndarray     # (M, 2) pixel (x, y)
    keypoints2: np.ndarray
    n_matches: int
    n_inliers: int
    rms_reproj: float          # normalized-coordinate units


def two_view_sfm(img1, img2, intrinsics, model: VGGDescriptor, *,
                 n_keypoints: int = 512, ratio: float = 0.85,
                 ransac_iters: int = 1024, ransac_thresh: float = 1e-5,
                 ba_iters: int = 12, draws=None) -> TwoViewResult:
    """Estimate relative pose + sparse structure for one image pair, on the
    model's device.

    intrinsics: (fx, fy, cx, cy). Images are (H, W) grayscale uint8/float
    (numpy or tensors). ``draws``: the RANSAC sample source (default
    ``DeviceDraws(0)`` on the model's device).
    """
    dev = model.projection.device
    if draws is None:
        draws = DeviceDraws(0, device=dev)
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    img1 = torch.as_tensor(np.asarray(img1)).to(dev)
    img2 = torch.as_tensor(np.asarray(img2)).to(dev)

    # detect + describe
    _, yx1, v1 = detect_corners(img1, k=n_keypoints)
    _, yx2, v2 = detect_corners(img2, k=n_keypoints)
    d1 = model.describe(extract_patches(img1, yx1))
    d2 = model.describe(extract_patches(img2, yx2))
    # invalidate padded detections by pushing them far away in desc space
    big = torch.tensor(1e6, dtype=torch.float32, device=dev)
    d1 = torch.where(v1[:, None], d1, big)
    d2 = torch.where(v2[:, None], d2, -big)

    # match with ratio test
    dists, idx = knn_match(d1, d2, k=2, block=min(4096, n_keypoints))
    midx, ok = ratio_test(dists, idx, ratio=ratio)
    ok = ok & v1

    # normalized coordinates of the matched pairs
    midx_safe = torch.clamp(midx, min=0).long()
    yx1f, yx2f = yx1.to(torch.float32), yx2.to(torch.float32)
    p1 = torch.stack([(yx1f[:, 1] - cx) / fx, (yx1f[:, 0] - cy) / fy], 1)
    p2 = torch.stack([(yx2f[:, 1] - cx) / fx, (yx2f[:, 0] - cy) / fy], 1)
    sel = torch.nonzero(ok)[:, 0]
    if sel.numel() < 8:
        raise ValueError(f"too few matches: {sel.numel()}")
    x1 = p1[sel]
    x2 = p2[midx_safe[sel]]

    sample = draws.ransac_idx(sel.numel(), ransac_iters, 8).to(dev)
    e, mask, n_inl = ransac_essential(x1, x2, sample, thresh=ransac_thresh)
    r, t, pts3d, _ = recover_pose(e, x1, x2, mask)

    ba = two_view_ba(r, t, pts3d, x1, x2, weights=mask.to(torch.float32),
                     n_iters=ba_iters)
    res = reprojection_residuals(ba.r, ba.t, ba.points, x1, x2)[mask]
    rms = (float(torch.sqrt((res ** 2).mean())) if res.numel()
           else float("nan"))

    mask_np = mask.cpu().numpy()
    sel_np = sel.cpu().numpy()
    kp1 = yx1.cpu().numpy()[sel_np][:, ::-1]  # (x, y)
    kp2 = yx2.cpu().numpy()[midx_safe.cpu().numpy()[sel_np]][:, ::-1]
    return TwoViewResult(
        rotation=ba.r.cpu().numpy(),
        translation=ba.t.cpu().numpy(),
        points3d=ba.points.cpu().numpy()[mask_np],
        keypoints1=kp1[mask_np],
        keypoints2=kp2[mask_np],
        n_matches=int(sel_np.size),
        n_inliers=int(n_inl),
        rms_reproj=rms,
    )
