"""Patch -> oriented-gradient feature transform ("get_desc").

Port of ``opencv_dlco_tpu/ops/patch_transform.py`` (reference:
src/vgg-desc.cpp:41-152). The separable Gaussian blur and the [-1,0,1]
gradient filters (both with replicate border) are dense 64x64 operator
matrices, so a batch of patches is blurred and differentiated with batched
float32 matmuls (TF32 is off, package __init__). Magnitude, orientation,
two-bin soft angular assignment and the 0.8-quantile normalisation are
elementwise and sort work over the batch.

Output layout: the reference flattens the patch in transposed
(column-major) order, flat index p = x*64 + y, which is the layout the
pooling filters (ops/pool_regions.py) use.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.configs import DescriptorConfig


def opencv_gaussian_ksize(sigma: float) -> int:
    """Aperture OpenCV derives for GaussianBlur(Size(0,0), sigma) on CV_32F."""
    k = int(round(sigma * 4.0 * 2.0 + 1.0))
    return k | 1


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """float32 Gaussian taps with OpenCV getGaussianKernel rounding semantics."""
    assert ksize % 2 == 1
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    taps64 = np.exp(-(xs * xs) / (2.0 * float(sigma) * float(sigma)))
    return (taps64 / taps64.sum()).astype(np.float32)


def _clamped_tap_matrix(n: int, taps: np.ndarray) -> np.ndarray:
    """(n, n) operator: out[o] = sum_t taps[t] * in[clip(o + t - r, 0, n-1)]."""
    r = (len(taps) - 1) // 2
    m = np.zeros((n, n), dtype=np.float64)
    for o in range(n):
        for t, k in enumerate(taps):
            src = min(max(o + t - r, 0), n - 1)
            m[o, src] += float(k)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=8)
def blur_matrix(patch_size: int, sigma: float) -> np.ndarray:
    """Dense (P, P) Gaussian blur-with-replicate-border operator."""
    taps = gaussian_kernel_1d(opencv_gaussian_ksize(sigma), sigma)
    return _clamped_tap_matrix(patch_size, taps)


@functools.lru_cache(maxsize=8)
def gradient_matrix(patch_size: int) -> np.ndarray:
    """Dense (P, P) central-difference operator for the [-1, 0, 1] kernel."""
    return _clamped_tap_matrix(
        patch_size, np.array([-1.0, 0.0, 1.0], dtype=np.float32))


def _quantile_coeffs(n: int, q: float):
    """Static (k, gamma) for the reference's mquantiles convention
    (src/vgg-desc.cpp:113-125)."""
    aleph = np.float32(np.float32(n) * np.float32(q) + np.float32(0.5))
    k = int(np.floor(aleph))
    k = min(max(k, 1), n - 1)
    gamma = np.float32(aleph - np.float32(k))
    gamma = float(np.clip(gamma, 0.0, 1.0))
    return k, gamma


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d constant on ``like``'s device (keeps every constant of
    the transform in float32, as the JAX version's np.float32 literals)."""
    return torch.tensor(np.float32(x), device=like.device)


def batch_patch_transform(patches: torch.Tensor,
                          cfg: DescriptorConfig = DescriptorConfig()
                          ) -> torch.Tensor:
    """(B, P, P) patches [row=y, col=x] -> (B, P*P, n_angle_bins) float32."""
    p = cfg.patch_size
    nb = cfg.n_angle_bins
    x = patches.to(torch.float32)
    dev = x.device
    m = torch.from_numpy(blur_matrix(p, cfg.init_sigma)).to(dev)
    g = torch.from_numpy(gradient_matrix(p)).to(dev)

    # blur(P) = M P M^T : rows (y) then cols (x)
    b = torch.matmul(m, torch.matmul(x, m.T))
    ix = torch.matmul(b, g.T)
    iy = torch.matmul(g, b)

    mag = torch.sqrt(ix * ix + iy * iy)
    ang = torch.atan2(iy, ix) + _f32(math.pi, x)

    ratio = ang / _f32(2.0 * math.pi / nb, x) - _f32(0.5, x)
    off = ratio - torch.floor(ratio)
    w1 = 1.0 - off
    w2 = off

    # Bin1 = ceil(ratio - 1) with -1 wrapping to nb-1 (src/vgg-desc.cpp:84-91)
    b1f = torch.ceil(ratio - 1.0)
    bin1 = torch.where(b1f == -1.0, torch.full_like(b1f, nb - 1),
                       b1f).to(torch.int64)
    bin2 = torch.where(bin1 + 1 > nb - 1, torch.zeros_like(bin1), bin1 + 1)

    if cfg.norm:
        k, gamma = _quantile_coeffs(p * p, cfg.norm_quantile)
        srt = torch.sort(mag.reshape(mag.shape[0], -1), dim=1).values
        t = (_f32(1.0 - gamma, x) * srt[:, k - 1]
             + _f32(gamma, x) * srt[:, k])[:, None, None]
        # the reference skips normalisation when T == 0 (flat patch,
        # src/vgg-desc.cpp:131); noise-scale quantiles count as zero contrast
        mag = torch.where(t > _f32(1e-4, x), mag / (t / _f32(nb, x)), mag)

    oh1 = torch.nn.functional.one_hot(bin1, nb).to(torch.float32)
    oh2 = torch.nn.functional.one_hot(bin2, nb).to(torch.float32)
    trans = (w1 * mag)[..., None] * oh1 + (w2 * mag)[..., None] * oh2
    # (B, y, x, nb) -> column-major flattening p = x*P + y
    return trans.transpose(1, 2).reshape(x.shape[0], p * p, nb)
