"""HPatches patches-release ingestion (BASELINE.json config 3).

The HPatches benchmark's patch distribution lays out one directory per
sequence, each holding tall grayscale PNG stacks of 65 x 65 patches:

    hpatches-release/
      i_ajuntament/              # 'i_' = illumination, 'v_' = viewpoint
        ref.png                  # reference patches, one per keypoint
        e1.png .. e5.png         # easy-difficulty warps of each keypoint
        h1.png .. h5.png         # hard
        t1.png .. t5.png         # tough

Row k of every stack is the same physical keypoint, so (ref[k], X[k]) is
a matched pair and any cross-row pair is non-matching — exactly the
verification / matching / retrieval protocols of pipeline/eval.py.

Patches are resized (pure-numpy bilinear) from the distribution's 65 x 65
to this package's 64 x 64 descriptor input. The reference has no HPatches
analogue (it stops at Brown-patch descriptor export).

Port of ``opencv_dlco_tpu/data/hpatches.py``: the loader is the same numpy
(cv2, else PIL, imported when an image is read); ``evaluate`` runs the
protocols of pipeline/eval.py on the descriptor's device.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

PATCH_NATIVE = 65
DIFFICULTIES = ("e", "h", "t")


def _load_gray(path: str) -> np.ndarray:
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise ValueError(f"cv2 failed to decode {path}")
        return img
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"))


def _split_stack(img: np.ndarray, patch: int = PATCH_NATIVE) -> np.ndarray:
    """Tall (K*patch, patch) stack -> (K, patch, patch)."""
    if img.shape[0] % patch or img.shape[1] != patch:
        raise ValueError(f"not a {patch}-px patch stack: {img.shape}")
    return img.reshape(-1, patch, patch)


def resize_patches(patches: np.ndarray, out: int = 64) -> np.ndarray:
    """(K, P, P) uint8 -> (K, out, out) uint8, separable bilinear."""
    k, p, _ = patches.shape
    src = (np.arange(out) + 0.5) * p / out - 0.5
    lo = np.clip(np.floor(src).astype(np.int64), 0, p - 1)
    hi = np.clip(lo + 1, 0, p - 1)
    frac = np.clip(src - lo, 0.0, 1.0).astype(np.float32)
    x = patches.astype(np.float32)
    x = x[:, lo, :] * (1 - frac)[None, :, None] \
        + x[:, hi, :] * frac[None, :, None]
    x = x[:, :, lo] * (1 - frac)[None, None, :] \
        + x[:, :, hi] * frac[None, None, :]
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


@dataclass
class HPatchesSequence:
    name: str
    ref: np.ndarray                      # (K, 64, 64) uint8
    warped: Dict[str, List[np.ndarray]]  # difficulty -> [(K, 64, 64), ...]

    @property
    def n_keypoints(self) -> int:
        return self.ref.shape[0]

    def pairs(self, difficulty: str = "e"):
        """All matched (ref, warped) pairs of one difficulty:
        (patches1 (M, 64, 64), patches2 (M, 64, 64)) with row-aligned
        identity, M = K * n_warps."""
        ws = self.warped[difficulty]
        p1 = np.concatenate([self.ref] * len(ws))
        p2 = np.concatenate(ws)
        return p1, p2


def load_sequence(seq_dir: str, out_size: int = 64) -> HPatchesSequence:
    ref_path = os.path.join(seq_dir, "ref.png")
    if not os.path.exists(ref_path):
        raise FileNotFoundError(ref_path)
    ref = resize_patches(_split_stack(_load_gray(ref_path)), out_size)
    warped: Dict[str, List[np.ndarray]] = {d: [] for d in DIFFICULTIES}
    for d in DIFFICULTIES:
        for path in sorted(glob.glob(os.path.join(seq_dir, f"{d}[0-9].png"))):
            w = resize_patches(_split_stack(_load_gray(path)), out_size)
            if w.shape[0] != ref.shape[0]:
                raise ValueError(
                    f"{path}: {w.shape[0]} patches vs ref {ref.shape[0]}")
            warped[d].append(w)
    return HPatchesSequence(name=os.path.basename(seq_dir.rstrip("/")),
                            ref=ref, warped=warped)


def load_benchmark(root: str, max_sequences: Optional[int] = None,
                   out_size: int = 64) -> List[HPatchesSequence]:
    """Load every i_*/v_* sequence directory under ``root``."""
    dirs = sorted(
        d for d in glob.glob(os.path.join(root, "*"))
        if os.path.isdir(d)
        and os.path.basename(d)[:2] in ("i_", "v_"))
    if not dirs:
        raise FileNotFoundError(f"no HPatches sequences under {root}")
    if max_sequences is not None:
        dirs = dirs[:max_sequences]
    return [load_sequence(d, out_size) for d in dirs]


def evaluate(describe, seqs: List[HPatchesSequence],
             difficulty: str = "e") -> Dict[str, float]:
    """Run the verification + matching protocols over loaded sequences.

    ``describe``: (B, 64, 64) uint8 patches (a CPU tensor) -> (B, D)
    descriptor tensor (e.g. VGGDescriptor.describe); the protocols run on
    the descriptors' device.
    """
    import torch

    from ..pipeline.eval import matching_map, verification

    fpr, auc, maps = [], [], []
    for seq in seqs:
        for w in seq.warped[difficulty]:
            d_ref = describe(torch.from_numpy(seq.ref))
            d_w = describe(torch.from_numpy(w))
            dev = d_ref.device
            k = seq.n_keypoints
            # verification: matched pairs + a shifted-row negative set
            neg = torch.from_numpy(np.roll(np.arange(k), max(1, k // 3)))
            d2 = torch.cat([d_w, d_w[neg.to(dev)]])
            labels = torch.cat([torch.ones(k, dtype=torch.int32),
                                torch.zeros(k, dtype=torch.int32)]).to(dev)
            m = verification(torch.cat([d_ref, d_ref]), d2, labels)
            fpr.append(m["fpr95"])
            auc.append(m["auc"])
            # matching: row-aligned ground truth
            mm = matching_map(d_ref, d_w,
                              torch.arange(k, dtype=torch.int32, device=dev))
            maps.append(mm["map"])
    return {"fpr95": float(np.mean(fpr)), "auc": float(np.mean(auc)),
            "matching_map": float(np.mean(maps)),
            "n_evals": len(fpr)}
