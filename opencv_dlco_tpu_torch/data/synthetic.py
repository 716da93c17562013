"""Synthetic datasets: planted-structure solver inputs + warped patch pairs.

The numpy half of ``opencv_dlco_tpu/data/synthetic.py``, copied so both
packages draw the same data from the same numpy seed:

- ``synth_pr_dataset``: distance matrices with a planted informative
  structure the PR solver must recover;
- ``synth_patch_pairs``: uint8 patch pairs where positives are warped +
  noised copies — drives the stage-1..3 descriptor/distance path;
- ``render_blob_sequence``: a rendered closed-loop monocular sequence, the
  SLAM benchmark scene.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synth_pr_dataset(rng: np.random.Generator, *, n_pos=2000, n_neg=2000,
                     n_feat=256, n_informative=16, sep=1.5):
    """Ring-distance-like matrices (pos, neg, informative_idx)."""
    info = rng.choice(n_feat, size=n_informative, replace=False)
    pos = np.abs(rng.normal(1.0, 0.5, size=(n_pos, n_feat))).astype(np.float32)
    neg = np.abs(rng.normal(1.0, 0.5, size=(n_neg, n_feat))).astype(np.float32)
    pos[:, info] = np.abs(rng.normal(0.3, 0.15, size=(n_pos, n_informative)))
    neg[:, info] = np.abs(rng.normal(0.3 + sep, 0.5, size=(n_neg, n_informative)))
    return pos.astype(np.float32), neg.astype(np.float32), info


def _smooth(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """Band-limited random images in [0, 1] (pure white noise has degenerate
    gradient statistics)."""
    freq = rng.normal(size=(n, size, size)) + 1j * rng.normal(size=(n, size, size))
    fy = np.fft.fftfreq(size)[None, :, None]
    fx = np.fft.fftfreq(size)[None, None, :]
    mask = np.exp(-((fx ** 2 + fy ** 2) * (size / 4.0) ** 2))
    img = np.fft.ifft2(freq * mask).real
    lo = img.min(axis=(1, 2), keepdims=True)
    hi = img.max(axis=(1, 2), keepdims=True)
    return (img - lo) / (hi - lo + 1e-9)


def render_blob_sequence(rng: np.random.Generator, n_frames: int = 48,
                         *, size: int = 256, f: float = 300.0,
                         n_blobs: int = 240, radius: float = 1.5,
                         closed_loop: bool = True
                         ) -> Tuple[list, np.ndarray, Tuple[float, float, float, float]]:
    """Rendered monocular sequence over a 3D Gaussian-blob field.

    Camera follows a circle in the x-y plane (closing the loop when
    ``closed_loop``), looking down +z — the SLAM benchmark scene (loop
    closures are detectable, not injected). Vectorised splatting (one
    (H*W, B) exp per frame) so rendering never dominates a benchmark run.

    Returns (frames [uint8 (size, size)], gt camera centers (F, 3),
    intrinsics (fx, fy, cx, cy)).
    """
    c = size / 2.0
    pts3d = np.stack([
        rng.uniform(-4, 4, n_blobs), rng.uniform(-4, 4, n_blobs),
        rng.uniform(5, 12, n_blobs)
    ], 1)
    amps = (rng.uniform(0.4, 1.0, n_blobs)
            * rng.choice([-1, 1], n_blobs)).astype(np.float32)
    sigmas = rng.uniform(2.0, 4.0, n_blobs).astype(np.float32)
    inv2s2 = (1.0 / (2.0 * sigmas ** 2)).astype(np.float32)
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    span = 2 * np.pi if closed_loop else np.pi
    frames, centers = [], []
    for i in range(n_frames):
        th = span * i / n_frames
        center = np.array([radius * (np.cos(th) - 1.0),
                           radius * np.sin(th), 0.0])
        yaw = 0.03 * np.sin(th)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        r_wc = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
        r = r_wc.T                      # world -> cam
        t = -r @ center
        p = pts3d @ r.T + t
        u = (f * p[:, 0] / p[:, 2] + c).astype(np.float32)
        v = (f * p[:, 1] / p[:, 2] + c).astype(np.float32)
        vis = ((u > -10) & (u < size + 10) & (v > -10) & (v < size + 10)
               & (p[:, 2] > 0.1))
        d2 = ((yy[:, :, None] - v[vis]) ** 2
              + (xx[:, :, None] - u[vis]) ** 2)
        img = np.einsum("hwb,b->hw", np.exp(-d2 * inv2s2[vis]), amps[vis])
        img = (img - img.min()) / (img.max() - img.min() + 1e-12)
        frames.append((img * 255).astype(np.uint8))
        centers.append(center)
    return frames, np.stack(centers), (f, f, c, c)


def _warp_bilinear(imgs: np.ndarray, dy, dx, angle, scale,
                   out_size: int) -> np.ndarray:
    """Batched similarity warp + crop: (N, H, W) -> (N, out, out).

    Inverse-mapped bilinear sampling about the image centre (rotate by
    ``angle``, scale by ``scale``, then translate by (dy, dx)); fully
    vectorised so pair generation never dominates a benchmark run."""
    n, h, w = imgs.shape
    yy, xx = np.mgrid[:out_size, :out_size].astype(np.float64)
    yc = yy - (out_size - 1) / 2.0
    xc = xx - (out_size - 1) / 2.0
    cos = np.cos(angle)[:, None, None]
    sin = np.sin(angle)[:, None, None]
    inv_s = 1.0 / scale[:, None, None]
    sy = (cos * yc + sin * xc) * inv_s + (h - 1) / 2.0 + dy[:, None, None]
    sx = (-sin * yc + cos * xc) * inv_s + (w - 1) / 2.0 + dx[:, None, None]
    y0 = np.clip(np.floor(sy).astype(np.int64), 0, h - 2)
    x0 = np.clip(np.floor(sx).astype(np.int64), 0, w - 2)
    fy = np.clip(sy - y0, 0.0, 1.0)
    fx = np.clip(sx - x0, 0.0, 1.0)
    b = np.arange(n)[:, None, None]
    v00 = imgs[b, y0, x0]
    v01 = imgs[b, y0, x0 + 1]
    v10 = imgs[b, y0 + 1, x0]
    v11 = imgs[b, y0 + 1, x0 + 1]
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


# Hardened pair distribution for precision gating (VERDICT r2 item 2): the
# legacy defaults are so separable that FPR95 = 0 at any matmul precision,
# which makes a |dFPR95| gate vacuous. These knobs put the f32 FPR95 of a
# uniform-pooled descriptor in the 5-20% band of the real Brown task
# (reference: workspace/pr-result-table.txt:7-17), so the bf16 gate can
# actually fail. Calibrated in bench_precision_fpr95.
HARD_PAIR_PARAMS = dict(noise=0.10, shift=5, rot=0.30, scale_jitter=0.18,
                        contrast_jitter=0.35, neg_overlap=0.45)


def synth_patch_pairs(rng: np.random.Generator, n_pairs: int = 256,
                      patch_size: int = 64, pos_frac: float = 0.5,
                      noise: float = 0.06, shift: int = 2,
                      rot: float = 0.0, scale_jitter: float = 0.0,
                      contrast_jitter: float = 0.0, neg_overlap: float = 0.0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (patches1, patches2, labels): uint8 (N, P, P) x2 + {0,1} (N,).

    Positives are warped (shift/rotation/scale) + photometrically jittered
    + noised copies of the same base texture; negatives are independent
    textures, optionally blended with the first patch's texture
    (``neg_overlap``) to create hard negatives that share structure. With
    the default zero warp/jitter knobs this reproduces the original easy
    distribution bit-for-bit; ``HARD_PAIR_PARAMS`` is the calibrated hard
    preset used by the precision gates.
    """
    n_pos = int(n_pairs * pos_frac)
    if rot == 0.0 and scale_jitter == 0.0:
        base = _smooth(rng, n_pairs + (n_pairs - n_pos),
                       patch_size + 2 * shift)
        p1 = np.empty((n_pairs, patch_size, patch_size))
        p2 = np.empty((n_pairs, patch_size, patch_size))
        labels = np.zeros(n_pairs, dtype=np.uint8)
        c = shift
        for i in range(n_pairs):
            a = base[i]
            p1[i] = a[c:c + patch_size, c:c + patch_size]
            if i < n_pos:
                dy, dx = rng.integers(-shift, shift + 1, size=2)
                p2[i] = a[c + dy:c + dy + patch_size,
                          c + dx:c + dx + patch_size]
                labels[i] = 1
            else:
                b = base[n_pairs + (i - n_pos)]
                p2[i] = b[c:c + patch_size, c:c + patch_size]
    else:
        # margin covering the worst-case warp so sampling never clamps
        margin = shift + int(np.ceil(
            0.5 * patch_size * (np.sin(rot) + scale_jitter))) + 1
        base = _smooth(rng, n_pairs + (n_pairs - n_pos),
                       patch_size + 2 * margin)
        zero = np.zeros(n_pairs)
        one = np.ones(n_pairs)
        p1 = _warp_bilinear(base[:n_pairs], zero, zero, zero, one,
                            patch_size)
        dy = rng.uniform(-shift, shift, n_pairs)
        dx = rng.uniform(-shift, shift, n_pairs)
        ang = rng.uniform(-rot, rot, n_pairs)
        sc = np.exp(rng.uniform(-np.log1p(scale_jitter),
                                np.log1p(scale_jitter), n_pairs))
        p2 = _warp_bilinear(base[:n_pairs], dy, dx, ang, sc, patch_size)
        labels = np.zeros(n_pairs, dtype=np.uint8)
        labels[:n_pos] = 1
        others = _warp_bilinear(base[n_pairs:], zero[n_pos:], zero[n_pos:],
                                zero[n_pos:], one[n_pos:], patch_size)
        # hard negatives: blend the query texture in, so negatives share
        # low-frequency structure with their query instead of being
        # statistically independent
        p2[n_pos:] = neg_overlap * p1[n_pos:] + (1.0 - neg_overlap) * others
    if contrast_jitter > 0.0:
        gain = 1.0 + rng.uniform(-contrast_jitter, contrast_jitter,
                                 (n_pairs, 1, 1))
        bias = rng.uniform(-0.5 * contrast_jitter, 0.5 * contrast_jitter,
                           (n_pairs, 1, 1))
        p2 = (p2 - 0.5) * gain + 0.5 + bias
    p1 = p1 + rng.normal(0, noise, p1.shape)
    p2 = p2 + rng.normal(0, noise, p2.shape)
    to_u8 = lambda x: (np.clip(x, 0, 1) * 255).astype(np.uint8)
    return to_u8(p1), to_u8(p2), labels
