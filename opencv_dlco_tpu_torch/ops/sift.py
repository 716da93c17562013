"""SIFT-style baseline descriptor, batched as dense operator products.

Port of ``opencv_dlco_tpu/ops/sift.py``, the hand-crafted baseline of
BASELINE.json config 3 ("HPatches matching: DLCO descriptors vs SIFT
baseline"). The gradient front half reuses the dense operator matrices of
``ops/patch_transform`` (blur and central difference as (P, P) operators,
one batched product each); the products are f32 with TF32 off (the JAX
package's Precision.HIGHEST).

Descriptor: Lowe's classic layout — per-pixel gradient magnitude +
orientation, Gaussian-weighted over the patch, soft-assigned (2 x 2
spatial cells x 2 orientation bins per pixel through bilinear weight
matrices) into a 4 x 4 spatial grid of 8-bin orientation histograms ->
128-D; L2 normalise, clip at 0.2, renormalise.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import no_tf32
from .patch_transform import blur_matrix, gradient_matrix

N_SPATIAL = 4    # 4 x 4 descriptor grid
N_ANGLE = 8      # orientation bins
N_DIM = N_SPATIAL * N_SPATIAL * N_ANGLE  # 128

#: patches per forward in sift_describe (bounds the (B, P, P, 8) histogram)
DESCRIBE_BLOCK = 4096


@functools.lru_cache(maxsize=8)
def _spatial_weights(patch_size: int) -> np.ndarray:
    """(P, N_SPATIAL) bilinear weights of each pixel row/col onto the 4
    cell centres (shared across rows and columns by separability)."""
    coords = (np.arange(patch_size) + 0.5) / patch_size * N_SPATIAL - 0.5
    cells = np.arange(N_SPATIAL)
    w = np.maximum(0.0, 1.0 - np.abs(coords[:, None] - cells[None, :]))
    # edge pixels outside the outer cell centres keep full weight on the
    # nearest cell (standard clamping)
    w[coords < 0, 0] = 1.0
    w[coords > N_SPATIAL - 1, -1] = 1.0
    return w.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _gauss_window(patch_size: int) -> np.ndarray:
    """(P, P) isotropic Gaussian magnitude weighting (sigma = P/2)."""
    c = (patch_size - 1) / 2.0
    y = np.arange(patch_size) - c
    g = np.exp(-(y ** 2) / (2.0 * (patch_size / 2.0) ** 2))
    return np.outer(g, g).astype(np.float32)


def sift_fn(patch_size: int = 64, sigma: float = 1.4, clip: float = 0.2,
            device="cuda"):
    """Returns a (B, P, P) uint8/float -> (B, 128) f32 function whose
    operators live on ``device`` (inputs must lie there too)."""
    dev = torch.device(device)

    def op(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    by = op(blur_matrix(patch_size, sigma))
    gd = op(gradient_matrix(patch_size))
    sw = op(_spatial_weights(patch_size))
    gw = op(_gauss_window(patch_size))
    bins = torch.arange(N_ANGLE, device=dev)

    def forward(patches: torch.Tensor) -> torch.Tensor:
        no_tf32()
        img = patches.to(torch.float32) / 255.0
        img = torch.matmul(torch.matmul(by, img), by.T)    # separable blur
        ix = torch.matmul(img, gd.T)
        iy = torch.matmul(gd, img)
        mag = torch.sqrt(ix * ix + iy * iy) * gw
        ang = torch.atan2(iy, ix)                          # [-pi, pi]
        # soft orientation assignment: each pixel's magnitude splits
        # between its two nearest bins, continuous across bin edges
        t = (ang / (2.0 * np.pi) + 0.5) * N_ANGLE          # [0, 8]
        lo = torch.floor(t)
        frac = (t - lo)[..., None]
        lo = lo.long()[..., None] % N_ANGLE
        hi = (lo + 1) % N_ANGLE
        hist_px = mag[..., None] * ((lo == bins) * (1.0 - frac)
                                    + (hi == bins) * frac)  # (B, P, P, 8)
        # spatial pooling: rows then cols through the bilinear cell weights
        pooled = torch.einsum("yr,byxa->brxa", sw, hist_px)
        pooled = torch.einsum("xc,brxa->brca", sw, pooled)  # (B, 4, 4, 8)
        d = pooled.reshape(patches.shape[0], N_DIM)
        d = d / (torch.linalg.norm(d, dim=1, keepdim=True) + 1e-12)
        d = torch.clamp(d, max=clip)
        return d / (torch.linalg.norm(d, dim=1, keepdim=True) + 1e-12)

    return forward


@torch.no_grad()
def sift_describe(patches, patch_size: int = 64,
                  device="cuda") -> torch.Tensor:
    """Batched SIFT baseline: (B, P, P) patches (numpy or tensor) ->
    (B, 128) f32 descriptors on ``device``, DESCRIBE_BLOCK patches per
    forward."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"sift_describe(device={device!r}): CUDA is not "
                           f"available; pass device='cpu'")
    x = patches if torch.is_tensor(patches) else torch.as_tensor(
        np.asarray(patches))
    fn = sift_fn(patch_size, device=dev)
    outs = [fn(x[s:s + DESCRIBE_BLOCK].to(dev))
            for s in range(0, x.shape[0], DESCRIBE_BLOCK)]
    if not outs:
        return torch.empty((0, N_DIM), device=dev)
    return torch.cat(outs)
