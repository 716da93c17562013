"""Candidate pooling-region filter bank.

Re-design of the reference's gen-poolregion stage
(reference: src/gen-poolregion.cpp:51-80, :163-295):

- a ring-parameter grid (nr radii x nphi angles x nsigma widths, r fastest)
  generated with the same sequential float accumulation as the C++ loops so
  grid values match to the double bit,
- 8 symmetric (y, x) offsets per ring,
- one normalised, 3-sigma-box-truncated Gaussian pooling filter per offset,
  flattened in [x, y] order to line up with the patch transform's
  column-major flattening (see ops/patch_transform.py).

Unlike the reference (a triple scalar loop over 40,960 filters), the whole
bank is built as one vectorised numpy broadcast in float64 and cast to
float32. This is host-side setup code (runs once, cached to the artifact
store); the bank is consumed on-device by ops/pair_distance.py.
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.configs import PoolRegionConfig


def _accum_range(v0: float, v1: float, n: int) -> np.ndarray:
    """Sequential `for (v = v0; v <= v1; v += (v1-v0)/(n-1))` accumulation.

    Reproduces the reference's running-sum grids (src/gen-poolregion.cpp:189-194)
    including their floating-point drift, rather than using linspace.
    """
    step = (v1 - v0) / (n - 1)
    out = []
    v = v0
    # The default grids accumulate exactly (steps 1.0, 0.5, pi/16 are all
    # closed under the running sum), matching the C++ `v <= v1` loop
    # bit-for-bit. The epsilon only rescues *non-default* grids whose
    # accumulated endpoint overshoots v1 by float rounding — it never
    # admits an extra point for the defaults (the next value overshoots
    # by a whole step).
    while v <= v1 + abs(step) * 1e-9:
        out.append(v)
        v = v + step
    return np.asarray(out, dtype=np.float64)


def ring_params(cfg: PoolRegionConfig = PoolRegionConfig()) -> np.ndarray:
    """(n_rings, 3) float64 rows of (r, phi, sigma); r fastest, sigma slowest."""
    patch_rad = (cfg.patch_size - 1) // 2
    rs = _accum_range(0.0, float(patch_rad), cfg.nr)
    phis = _accum_range(0.0, math.pi / 4.0, cfg.nphi)
    sigmas = _accum_range(0.5, math.ceil(patch_rad / 2.0), cfg.nsigma)
    if not (len(rs) == cfg.nr and len(phis) == cfg.nphi and len(sigmas) == cfg.nsigma):
        raise AssertionError(
            f"grid drift: got ({len(rs)},{len(phis)},{len(sigmas)}) "
            f"expected ({cfg.nr},{cfg.nphi},{cfg.nsigma})"
        )
    grid = np.zeros((cfg.nsigma, cfg.nphi, cfg.nr, 3), dtype=np.float64)
    grid[..., 0] = rs[None, None, :]
    grid[..., 1] = phis[None, :, None]
    grid[..., 2] = sigmas[:, None, None]
    return grid.reshape(-1, 3)


def ring_offsets(rings: np.ndarray) -> np.ndarray:
    """(n_rings, 8, 2) float64 symmetric offsets as (y, x) pairs.

    Order matches reference: src/gen-poolregion.cpp:247-257.
    """
    r, phi = rings[:, 0], rings[:, 1]
    xc = r * np.cos(phi)
    yc = r * np.sin(phi)
    off = np.stack(
        [
            np.stack([yc, xc], -1),
            np.stack([yc, -xc], -1),
            np.stack([-yc, xc], -1),
            np.stack([-yc, -xc], -1),
            np.stack([xc, yc], -1),
            np.stack([xc, -yc], -1),
            np.stack([-xc, -yc], -1),
            np.stack([-xc, yc], -1),
        ],
        axis=1,
    )
    return off


def pr_params64(cfg: PoolRegionConfig = PoolRegionConfig(),
                rings: np.ndarray | None = None) -> np.ndarray:
    """(n_filters, 3) float64 rows of (x0, y0, sigma) per filter.

    This is the full-precision parameterisation the filters are generated
    from (the reference passes the double Offsets into get_PR_filter,
    src/gen-poolregion.cpp:263-266).
    """
    if rings is None:
        rings = ring_params(cfg)
    off = ring_offsets(rings)  # (R, 8, 2) as (y, x)
    n = rings.shape[0]
    out = np.zeros((n, cfg.n_symmetries, 3), dtype=np.float64)
    out[..., 0] = off[..., 1]  # x
    out[..., 1] = off[..., 0]  # y
    out[..., 2] = rings[:, None, 2]
    return out.reshape(-1, 3)


def pr_params(cfg: PoolRegionConfig = PoolRegionConfig(),
              rings: np.ndarray | None = None) -> np.ndarray:
    """(n_filters, 3) float32 rows of (x0, y0, sigma) per filter.

    The float32 *stored* PRParams artifact
    (reference: src/gen-poolregion.cpp:272-275 stores (x, y, sigma)).
    """
    return pr_params64(cfg, rings).astype(np.float32)


def pr_filters(params: np.ndarray, patch_size: int = 64,
               block: int = 2048) -> np.ndarray:
    """(n_filters, patch_size**2) float32 normalised Gaussian pooling filters.

    Equivalent of get_PR_filter (reference: src/gen-poolregion.cpp:51-80) with
    the extended-grid + crop folded into a direct masked evaluation on the
    cropped grid: for crop pixel (i, j) (i along x, j along y, 0-based),

        F[i, j] = exp(-((i+1-cx)^2 + (j+1-cy)^2) / (2 sigma^2))

    where (cx, cy) = (x0, y0) + 0.5*(1 + patch_size), masked to the C++
    loop's 3-sigma box  floor(cx-3s) <= i+1 <= ceil(cx+3s)  (and same for j;
    the rExt extension offset cancels), then normalised to unit sum over the
    crop. Flattening is [x-major]: flat = i*patch_size + j.
    """
    params = np.asarray(params, dtype=np.float64)
    n = params.shape[0]
    p = patch_size
    shift = 0.5 * (1.0 + p)
    coords = np.arange(1, p + 1, dtype=np.float64)  # i+1 / j+1
    out = np.empty((n, p * p), dtype=np.float32)
    for s in range(0, n, block):
        e = min(s + block, n)
        cx = params[s:e, 0] + shift
        cy = params[s:e, 1] + shift
        sig = params[s:e, 2]
        dx = coords[None, :] - cx[:, None]  # (b, p)
        dy = coords[None, :] - cy[:, None]
        mx = (coords[None, :] >= np.floor(cx - 3.0 * sig)[:, None]) & (
            coords[None, :] <= np.ceil(cx + 3.0 * sig)[:, None]
        )
        my = (coords[None, :] >= np.floor(cy - 3.0 * sig)[:, None]) & (
            coords[None, :] <= np.ceil(cy + 3.0 * sig)[:, None]
        )
        inv2s2 = 1.0 / (2.0 * sig * sig)
        # (b, p_x, p_y)
        r2 = dx[:, :, None] ** 2 + dy[:, None, :] ** 2
        f = np.exp(-r2 * inv2s2[:, None, None]).astype(np.float32)
        f = np.where(mx[:, :, None] & my[:, None, :], f, np.float32(0.0))
        f = f.reshape(e - s, p * p)
        sums = f.sum(axis=1, dtype=np.float64)
        out[s:e] = (f / sums[:, None]).astype(np.float32)
    return out


def build_filter_bank(cfg: PoolRegionConfig = PoolRegionConfig()):
    """Full bank: (rings, prparams, filters) matching the reference schema

    RingParams (n_rings, 3) f64, PRParams (n_filters, 3) f32,
    PRFilters (n_filters, patch_size^2) f32.
    """
    rings = ring_params(cfg)
    params64 = pr_params64(cfg, rings)
    filters = pr_filters(params64, cfg.patch_size)
    return rings, params64.astype(np.float32), filters
