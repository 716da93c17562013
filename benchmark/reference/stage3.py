"""Plain reference of stage 3: the bank, the patch transform, ring distances.

Plain PyTorch in float32 with TF32 off (float64 for the bank, as the
reference C++ builds it), from the published description
(src/gen-poolregion.cpp, src/vgg-desc.cpp, src/comp-fulldists.cpp). It
imports nothing of the program and takes nothing the program made: it
builds its own bank and transforms the patches itself.

The transform follows the same sequence of float32 operations as the
program's and runs on the same batches (a whole block of patches), so
the two agree bit for bit on the gradients: a gradient whose angle falls
exactly on a bin edge is binned by ``ceil(ratio - 1)``, a jump that the
smallest difference in the blur would move to the next bin.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import set_tf32


# -- the pooling-region bank (src/gen-poolregion.cpp:51-80, :163-295) -------

def _grid(v0: float, v1: float, n: int) -> list:
    """The C++ loop ``for (v = v0; v <= v1; v += (v1 - v0) / (n - 1))``."""
    step = (v1 - v0) / (n - 1)
    out, v = [], v0
    while v <= v1 + abs(step) * 1e-9:
        out.append(v)
        v += step
    if len(out) != n:
        raise ValueError(f"grid of {len(out)} values, expected {n}")
    return out


def bank(pool: dict, device) -> torch.Tensor:
    """(n_rings * n_sym, P * P) float32 normalised Gaussian pooling
    filters, ring-major, flattened x-major (flat = x * P + y)."""
    p = pool["patch_size"]
    rad = (p - 1) // 2
    rs = _grid(0.0, float(rad), pool["nr"])
    phis = _grid(0.0, math.pi / 4.0, pool["nphi"])
    sigmas = _grid(0.5, math.ceil(rad / 2.0), pool["nsigma"])
    f64 = dict(dtype=torch.float64, device=device)
    # rings: r fastest, sigma slowest
    r = torch.tensor(rs, **f64).repeat(len(sigmas) * len(phis))
    phi = torch.tensor(phis, **f64).repeat_interleave(len(rs)).repeat(
        len(sigmas))
    sig = torch.tensor(sigmas, **f64).repeat_interleave(len(rs) * len(phis))
    xc, yc = r * torch.cos(phi), r * torch.sin(phi)
    # the 8 symmetric offsets as (y, x), in the C++ order
    ys = torch.stack([yc, yc, -yc, -yc, xc, xc, -xc, -xc], 1).reshape(-1)
    xs = torch.stack([xc, -xc, xc, -xc, yc, -yc, -yc, yc], 1).reshape(-1)
    sig = sig.repeat_interleave(8)
    shift = 0.5 * (1.0 + p)
    cx, cy = xs + shift, ys + shift
    coord = torch.arange(1, p + 1, **f64)
    mx = ((coord[None] >= torch.floor(cx - 3 * sig)[:, None])
          & (coord[None] <= torch.ceil(cx + 3 * sig)[:, None]))
    my = ((coord[None] >= torch.floor(cy - 3 * sig)[:, None])
          & (coord[None] <= torch.ceil(cy + 3 * sig)[:, None]))
    out = torch.empty((sig.shape[0], p * p), dtype=torch.float32,
                      device=device)
    for s in range(0, sig.shape[0], 4096):
        e = s + 4096
        dx = coord[None] - cx[s:e, None]
        dy = coord[None] - cy[s:e, None]
        r2 = dx[:, :, None] ** 2 + dy[:, None, :] ** 2
        g = torch.exp(-r2 / (2.0 * sig[s:e, None, None] ** 2)).float()
        g = torch.where(mx[s:e, :, None] & my[s:e, None, :], g,
                        torch.zeros((), dtype=torch.float32, device=device))
        g = g.reshape(g.shape[0], -1)
        out[s:e] = (g / g.double().sum(1, keepdim=True)).float()
    return out


# -- the patch transform (src/vgg-desc.cpp:41-152) -------------------------

def _taps(sigma: float) -> np.ndarray:
    k = int(round(sigma * 8.0 + 1.0)) | 1
    xs = np.arange(k, dtype=np.float64) - (k - 1) * 0.5
    t = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (t / t.sum()).astype(np.float32)


def _operator(n: int, taps: np.ndarray) -> np.ndarray:
    """out[o] = sum_t taps[t] in[clip(o + t - r)]: replicate border."""
    r = (len(taps) - 1) // 2
    m = np.zeros((n, n), np.float64)
    for o in range(n):
        for t, k in enumerate(taps):
            m[o, min(max(o + t - r, 0), n - 1)] += float(k)
    return m.astype(np.float32)


def transform(patches: torch.Tensor, desc: dict) -> torch.Tensor:
    """(B, P, P) uint8 [y, x] -> (B, P * P, n_bins) float32, flat = x*P+y."""
    p, nb = desc["patch_size"], desc["n_angle_bins"]
    x = patches.to(torch.float32)
    dev = x.device

    def c(v):
        return torch.tensor(np.float32(v), device=dev)

    m = torch.from_numpy(_operator(p, _taps(desc["init_sigma"]))).to(dev)
    g = torch.from_numpy(_operator(
        p, np.array([-1.0, 0.0, 1.0], np.float32))).to(dev)
    b = torch.matmul(m, torch.matmul(x, m.T))
    ix = torch.matmul(b, g.T)
    iy = torch.matmul(g, b)
    mag = torch.sqrt(ix * ix + iy * iy)
    ang = torch.atan2(iy, ix) + c(math.pi)
    ratio = ang / c(2.0 * math.pi / nb) - c(0.5)
    off = ratio - torch.floor(ratio)
    b1 = torch.ceil(ratio - 1.0)
    bin1 = torch.where(b1 == -1.0, torch.full_like(b1, nb - 1),
                       b1).to(torch.int64)
    bin2 = torch.where(bin1 + 1 > nb - 1, torch.zeros_like(bin1), bin1 + 1)
    if desc["norm"]:
        n = p * p
        aleph = np.float32(np.float32(n) * np.float32(desc["norm_quantile"])
                           + np.float32(0.5))
        k = min(max(int(np.floor(aleph)), 1), n - 1)
        gam = float(np.clip(np.float32(aleph - np.float32(k)), 0.0, 1.0))
        srt = torch.sort(mag.reshape(mag.shape[0], -1), dim=1).values
        t = (c(1.0 - gam) * srt[:, k - 1] + c(gam) * srt[:, k])[:, None, None]
        mag = torch.where(t > c(1e-4), mag / (t / c(nb)), mag)
    oh1 = torch.nn.functional.one_hot(bin1, nb).to(torch.float32)
    oh2 = torch.nn.functional.one_hot(bin2, nb).to(torch.float32)
    out = ((1.0 - off) * mag)[..., None] * oh1 + (off * mag)[..., None] * oh2
    return out.transpose(1, 2).reshape(x.shape[0], p * p, nb)


# -- ring distances (src/comp-fulldists.cpp:294-356) -----------------------

def ring_distances(filters: torch.Tensor, pt1: torch.Tensor,
                   pt2: torch.Tensor, n_sym: int, chunk: int = 512):
    """(B, n_rings): per ring, the sum over its n_sym filters and the bins
    of (min(F pt2, 1) - min(F pt1, 1))^2."""
    out = []
    for s in range(0, pt1.shape[0], chunk):
        d1 = torch.clamp(torch.matmul(filters, pt1[s:s + chunk]), max=1.0)
        d2 = torch.clamp(torch.matmul(filters, pt2[s:s + chunk]), max=1.0)
        sq = ((d2 - d1) ** 2).sum(dim=2)
        out.append(sq.reshape(sq.shape[0], -1, n_sym).sum(dim=2))
    return torch.cat(out)


def rows(config: dict, patches: np.ndarray, indices: np.ndarray,
         pairs: np.ndarray, device, tf32: bool = False) -> torch.Tensor:
    """The reference's Distance rows of ``pairs`` (sorted), each block of
    ``pair_block`` pairs transformed whole, as stage 3 batches it."""
    set_tf32(tf32)
    try:
        filters = bank(config["pool_regions"], device)
        blk = config["pair_block"]
        out = []
        for b in np.unique(pairs // blk):
            lo = b * blk
            hi = min(lo + blk, indices.shape[0])
            sel = torch.from_numpy(pairs[(pairs >= lo) & (pairs < hi)] - lo
                                   ).to(device)

            def pt(col):
                p = torch.from_numpy(patches[indices[lo:hi, col]]).to(device)
                return transform(p, config["descriptor"])[sel]

            out.append(ring_distances(filters, pt(0), pt(2),
                                      config["pool_regions"]["n_symmetries"]))
        return torch.cat(out)
    finally:
        set_tf32(False)
