"""KITTI odometry-format ingestion.

Port of ``opencv_dlco_tpu/data/kitti.py``. The KITTI odometry layout:

    root/
      sequences/<seq>/calib.txt          # P0..P3 projection matrices
      sequences/<seq>/image_0/*.png      # left gray camera frames
      sequences/<seq>/times.txt          # per-frame timestamps (optional)
      poses/<seq>.txt                    # 12 floats/line: [R|t] cam->world

Poses are camera-to-world of the left gray camera (x_world = R x_cam + t),
the SlamResult world_T_frame convention, so a loaded ground truth compares
directly with ``pipeline/slam`` output through ``ate_rmse``.

Images decode through ``native.load_gray``: ``.bmp`` with the native
decoder, other formats with cv2, or PIL when cv2 is missing.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class KittiSequence:
    frame_paths: List[str]            # ordered image files
    intrinsics: Tuple[float, float, float, float]   # fx, fy, cx, cy
    poses: Optional[np.ndarray]       # (F, 3, 4) cam->world, None if absent
    times: Optional[np.ndarray]       # (F,) seconds, None if absent

    def __len__(self) -> int:
        return len(self.frame_paths)

    def load_frame(self, i: int) -> np.ndarray:
        return load_image_gray(self.frame_paths[i])

    def gt_centers(self) -> np.ndarray:
        """Ground-truth camera centers (F, 3): the t column of each pose."""
        if self.poses is None:
            raise ValueError("sequence has no ground-truth poses")
        return self.poses[:, :, 3]


def parse_poses(path: str) -> np.ndarray:
    """poses/<seq>.txt -> (F, 3, 4) float64 [R|t] cam->world matrices."""
    vals = np.loadtxt(path, dtype=np.float64)
    if vals.ndim == 1:
        vals = vals[None]
    if vals.shape[1] != 12:
        raise ValueError(f"expected 12 values per pose line, got "
                         f"{vals.shape[1]} in {path}")
    return vals.reshape(-1, 3, 4)


def parse_calib(path: str) -> dict:
    """calib.txt -> {name: (3, 4) float64} for P0..P3 (and Tr if present)."""
    out = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or ":" not in line:
                continue
            name, rest = line.split(":", 1)
            try:
                vals = np.array(rest.split(), dtype=np.float64)
            except ValueError:      # not a matrix line
                continue
            if vals.size == 12:
                out[name.strip()] = vals.reshape(3, 4)
    return out


def intrinsics_from_projection(p: np.ndarray
                               ) -> Tuple[float, float, float, float]:
    """(3, 4) projection matrix -> (fx, fy, cx, cy)."""
    return float(p[0, 0]), float(p[1, 1]), float(p[0, 2]), float(p[1, 2])


def load_image_gray(path: str) -> np.ndarray:
    """Decode one frame to uint8 (H, W) grayscale."""
    from ..native import load_gray

    return load_gray(path)


def load_sequence(root: str, seq: str, camera: str = "image_0",
                  max_frames: Optional[int] = None) -> KittiSequence:
    """Load one odometry sequence's metadata (frames decode lazily)."""
    seq_dir = os.path.join(root, "sequences", seq)
    img_dir = os.path.join(seq_dir, camera)
    paths = sorted(
        p for p in glob.glob(os.path.join(img_dir, "*"))
        if os.path.splitext(p)[1].lower() in (".png", ".jpg", ".bmp", ".pgm")
    )
    if not paths:
        raise FileNotFoundError(f"no frames under {img_dir}")
    if max_frames is not None:
        paths = paths[:max_frames]

    calib = parse_calib(os.path.join(seq_dir, "calib.txt"))
    cam_key = f"P{camera[-1]}" if camera[-1].isdigit() else "P0"
    if cam_key not in calib:
        raise ValueError(f"{cam_key} missing from calib.txt "
                         f"(has {sorted(calib)})")
    intr = intrinsics_from_projection(calib[cam_key])

    poses = None
    pose_path = os.path.join(root, "poses", f"{seq}.txt")
    if os.path.exists(pose_path):
        poses = parse_poses(pose_path)
        if max_frames is not None:
            poses = poses[:max_frames]

    times = None
    time_path = os.path.join(seq_dir, "times.txt")
    if os.path.exists(time_path):
        times = np.loadtxt(time_path, dtype=np.float64)
        if max_frames is not None:
            times = times[:max_frames]

    return KittiSequence(frame_paths=paths, intrinsics=intr,
                         poses=poses, times=times)


def evaluate_against_gt(result, seq: KittiSequence,
                        with_scale: bool = True) -> dict:
    """ATE-RMSE of a SlamResult trajectory against the sequence's poses."""
    from ..pipeline.slam import ate_rmse

    centers = seq.gt_centers()[:result.translations.shape[0]]
    ate = ate_rmse(result.translations, centers, with_scale=with_scale)
    span = float(np.linalg.norm(centers.max(0) - centers.min(0)))
    return {"ate_rmse": ate, "span": span,
            "ate_rel": ate / max(span, 1e-12),
            "n_frames": int(result.translations.shape[0])}
