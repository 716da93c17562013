"""Stage 3's input: Brown-style 64 x 64 uint8 patch pairs from a seed.

A frozen copy of the port's ``data/synthetic.synth_patch_pairs_device``
with ``HARD_PAIR_PARAMS``, the generator the ``e2e`` command's stage 1
uses: band-limited FFT textures, similarity-warped positives, blended hard
negatives, photometric jitter and noise, drawn on the device from a
``torch.Generator``. The arrays come out in the stage-1 dataset's layout:
``patches`` (2N, 64, 64) and ``indices`` (N, 4) int32, pair i referencing
patches (i, N + i), positives first in every chunk.
"""

from __future__ import annotations

import numpy as np
import torch

HARD_PAIR_PARAMS = dict(noise=0.10, shift=5, rot=0.30, scale_jitter=0.18,
                        contrast_jitter=0.35, neg_overlap=0.45)
PATCH = 64


def seed_of(seed: int, tag: int) -> int:
    """A generator seed for stream ``tag`` of a run's ``--seed``."""
    return (int(seed) * 1_000_003 + int(tag)) % (1 << 63)


def _smooth(normal, n: int, size: int, dev) -> torch.Tensor:
    freq = torch.complex(normal((n, size, size)), normal((n, size, size)))
    f1 = torch.fft.fftfreq(size, device=dev, dtype=torch.float32)
    mask = torch.exp(-((f1[:, None] ** 2 + f1[None, :] ** 2)
                       * (size / 4.0) ** 2))
    img = torch.fft.ifft2(freq * mask).real
    del freq
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    return (img - lo) / (hi - lo + 1e-9)


def _warp(imgs, dy, dx, angle, scale, out_size: int) -> torch.Tensor:
    n, h, w = imgs.shape
    ar = torch.arange(out_size, device=imgs.device, dtype=torch.float32)
    yc = (ar - (out_size - 1) / 2.0)[:, None]
    xc = (ar - (out_size - 1) / 2.0)[None, :]
    cos = torch.cos(angle)[:, None, None]
    sin = torch.sin(angle)[:, None, None]
    inv_s = 1.0 / scale[:, None, None]
    sy = (cos * yc + sin * xc) * inv_s + (h - 1) / 2.0 + dy[:, None, None]
    sx = (-sin * yc + cos * xc) * inv_s + (w - 1) / 2.0 + dx[:, None, None]
    y0 = torch.clamp(torch.floor(sy).long(), 0, h - 2)
    x0 = torch.clamp(torch.floor(sx).long(), 0, w - 2)
    fy = torch.clamp(sy - y0, 0.0, 1.0)
    fx = torch.clamp(sx - x0, 0.0, 1.0)
    flat = imgs.reshape(n, h * w)

    def gather(oy, ox):
        idx = ((y0 + oy) * w + (x0 + ox)).reshape(n, -1)
        return torch.gather(flat, 1, idx).reshape(y0.shape)

    return (gather(0, 0) * (1 - fy) * (1 - fx) + gather(0, 1) * (1 - fy) * fx
            + gather(1, 0) * fy * (1 - fx) + gather(1, 1) * fy * fx)


def _pairs(n_pairs: int, g: torch.Generator, dev, noise, shift, rot,
           scale_jitter, contrast_jitter, neg_overlap, pos_frac=0.5):
    n_pos = int(n_pairs * pos_frac)
    n_neg = n_pairs - n_pos
    margin = shift + int(np.ceil(
        0.5 * PATCH * (np.sin(rot) + scale_jitter))) + 1
    size = PATCH + 2 * margin

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    def normal(shape):
        return torch.randn(shape, generator=g, device=dev)

    base = _smooth(normal, n_pairs + n_neg, size, dev)
    p1 = base[:n_pairs, margin:margin + PATCH, margin:margin + PATCH]
    dy = uniform((n_pairs,), -shift, shift)
    dx = uniform((n_pairs,), -shift, shift)
    ang = uniform((n_pairs,), -rot, rot)
    sc = torch.exp(uniform((n_pairs,), -np.log1p(scale_jitter),
                           np.log1p(scale_jitter)))
    p2 = _warp(base[:n_pairs], dy, dx, ang, sc, PATCH)
    others = base[n_pairs:, margin:margin + PATCH, margin:margin + PATCH]
    p2[n_pos:] = neg_overlap * p1[n_pos:] + (1.0 - neg_overlap) * others
    del base, others
    gain = 1.0 + uniform((n_pairs, 1, 1), -contrast_jitter, contrast_jitter)
    bias = uniform((n_pairs, 1, 1), -0.5 * contrast_jitter,
                   0.5 * contrast_jitter)
    p2 = (p2 - 0.5) * gain + 0.5 + bias
    p1 = p1 + noise * normal(p1.shape)
    p2 = p2 + noise * normal(p2.shape)

    def to_u8(x):
        return (torch.clamp(x, 0, 1) * 255).to(torch.uint8).cpu().numpy()

    labels = np.zeros(n_pairs, dtype=np.uint8)
    labels[:n_pos] = 1
    return to_u8(p1), to_u8(p2), labels


def make(n_pairs: int, seed: int, chunk: int, device="cuda"):
    """(patches, indices) of ``n_pairs`` pairs drawn from ``seed``, in
    chunks of ``chunk`` pairs (every chunk the same size, so every seed
    draws the same amount)."""
    if n_pairs % chunk:
        raise ValueError(f"n_pairs {n_pairs} is not a multiple of {chunk}")
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed_of(seed, 1))
    patches = np.empty((2 * n_pairs, PATCH, PATCH), np.uint8)
    indices = np.zeros((n_pairs, 4), np.int32)
    indices[:, 0] = np.arange(n_pairs)
    indices[:, 1] = indices[:, 0]
    indices[:, 2] = np.arange(n_pairs) + n_pairs
    for s in range(0, n_pairs, chunk):
        p1, p2, labels = _pairs(chunk, g, dev, **HARD_PAIR_PARAMS)
        patches[s:s + chunk] = p1
        patches[n_pairs + s:n_pairs + s + chunk] = p2
        rows = indices[s:s + chunk]
        rows[:, 3] = np.where(labels == 1, rows[:, 0], rows[:, 2])
    return patches, indices
