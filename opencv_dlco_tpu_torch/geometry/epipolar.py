"""Two-view epipolar geometry: essential-matrix estimation and batched RANSAC.

Port of ``opencv_dlco_tpu/geometry/epipolar.py``. RANSAC is one batched
program: all H hypotheses are solved (batched 8-point on (..., H, 9, 9)
``eigh``) and scored against all N correspondences at once (one (..., H, N)
Sampson-distance table), the best is picked by argmax and refit on its
inliers. Every function takes leading batch axes, so the SLAM pose chunk
runs its C pairs as one call.

The sample indices are an input: ``ransac_essential`` takes the (..., H, 8)
table of draws (the JAX function draws it from a key inside), so callers
choose the random source and tests can replay the JAX draws.

Points are in normalized camera coordinates (K^-1 applied) unless noted.
"""

from __future__ import annotations

import math

import torch

from .triangulate import triangulate_points


def normalize_points(x: torch.Tensor):
    """Hartley normalisation: (..., N, 2) -> (normalized, T (..., 3, 3))."""
    mean = x.mean(-2)
    d = torch.sqrt(torch.sum((x - mean[..., None, :]) ** 2, -1))
    scale = math.sqrt(2.0) / (d.mean(-1) + 1e-12)
    one = torch.ones_like(scale)
    zero = torch.zeros_like(scale)
    t = torch.stack([
        torch.stack([one, zero, -mean[..., 0]], -1) * scale[..., None],
        torch.stack([zero, one, -mean[..., 1]], -1) * scale[..., None],
        torch.stack([zero, zero, one], -1)], -2)
    return (x - mean[..., None, :]) * scale[..., None, None], t


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _design_matrix(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) x2 -> (..., N, 9) rows [x2x1, x2y1, x2, y2x1, y2y1, y2,
    x1, y1, 1] of x2^T E x1 = 0."""
    a = _homog(x2)[..., :, None] * _homog(x1)[..., None, :]
    return a.reshape(a.shape[:-2] + (9,))


def essential_project(e: torch.Tensor) -> torch.Tensor:
    """Project onto the essential manifold: singular values -> (s, s, 0)."""
    u, s, vt = torch.linalg.svd(e)
    sm = (s[..., 0] + s[..., 1]) * 0.5
    s_new = torch.stack([sm, sm, torch.zeros_like(sm)], -1)
    return torch.sum(u[..., :, :, None]
                     * (s_new[..., :, None] * vt)[..., None, :, :], -2)


def eight_point(x1: torch.Tensor, x2: torch.Tensor,
                weights: torch.Tensor | None = None) -> torch.Tensor:
    """(Weighted) 8-point algorithm on normalized coords -> E (..., 3, 3):
    the eigenvector of A^T A with the smallest eigenvalue."""
    a = _design_matrix(x1, x2)
    if weights is not None:
        a = a * weights[..., None]
    ata = torch.matmul(a.transpose(-1, -2), a)
    _, vecs = torch.linalg.eigh(ata)
    e = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    return essential_project(e)


def sampson_distance(e: torch.Tensor, x1: torch.Tensor,
                     x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric error of x2^T E x1 = 0: (..., N), as explicit
    broadcast sums in true f32 (the reference's scoring)."""
    x1h = _homog(x1)
    x2h = _homog(x2)
    ex1 = torch.sum(e[..., None, :, :] * x1h[..., None, :], -1)
    etx2 = torch.sum(e.transpose(-1, -2)[..., None, :, :]
                     * x2h[..., None, :], -1)
    num = torch.sum(x2h * ex1, -1) ** 2
    den = (ex1[..., 0] ** 2 + ex1[..., 1] ** 2
           + etx2[..., 0] ** 2 + etx2[..., 1] ** 2)
    return num / (den + 1e-12)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, c) at idx (..., H, S) -> (..., H, S, c)."""
    lead = idx.shape[:-2]
    h, s = idx.shape[-2:]
    flat = idx.reshape(lead + (h * s, 1)).expand(lead + (h * s, x.shape[-1]))
    return torch.gather(x.expand(lead + x.shape[-2:]), -2, flat).reshape(
        lead + (h, s, x.shape[-1]))


def ransac_essential(x1: torch.Tensor, x2: torch.Tensor, idx: torch.Tensor,
                     *, thresh: float = 1e-4,
                     n_valid: torch.Tensor | None = None):
    """Batched RANSAC for E over (..., N, 2) correspondences.

    ``idx`` (..., H, S) int holds each hypothesis's sample rows, drawn
    uniformly from [0, clip(n_valid, S, N)) (the reference draws them with
    ``jax.random.randint`` inside). ``n_valid`` (...,) marks a valid
    prefix: only rows < n_valid count as inliers (the compact-to-prefix
    contract of the batched SLAM front end). ``thresh`` is a Sampson
    distance in normalized-coordinate units.

    Returns (E (..., 3, 3), inlier_mask (..., N), n_inliers (...,)).
    """
    n = x1.shape[-2]
    ar = torch.arange(n, device=x1.device)
    if n_valid is None:
        valid = torch.ones(x1.shape[:-1], dtype=torch.bool, device=x1.device)
    else:
        valid = ar < n_valid[..., None]
    idx = idx.to(torch.int64)
    e_all = eight_point(_take_rows(x1, idx), _take_rows(x2, idx))  # (.., H)
    d = sampson_distance(e_all, x1[..., None, :, :], x2[..., None, :, :])
    inl = (d < thresh) & valid[..., None, :]                        # (.., H, N)
    scores = inl.sum(-1)
    best = torch.argmax(scores, -1)                                 # first max
    best_mask = torch.gather(
        inl, -2, best[..., None, None].expand(best.shape + (1, n)))[..., 0, :]
    e_best = torch.gather(
        e_all, -3, best[..., None, None, None].expand(best.shape + (1, 3, 3))
    )[..., 0, :, :]
    # masked least-squares refit on all inliers of the winner
    e_refit = eight_point(x1, x2, weights=best_mask.to(x1.dtype))
    d_refit = sampson_distance(e_refit, x1, x2)
    mask_refit = (d_refit < thresh) & valid
    # keep the refit only if it didn't lose inliers
    better = mask_refit.sum(-1) >= best_mask.sum(-1)
    e_final = torch.where(better[..., None, None], e_refit, e_best)
    mask_final = torch.where(better[..., None], mask_refit, best_mask)
    return e_final, mask_final, mask_final.sum(-1)


def decompose_essential(e: torch.Tensor):
    """E -> 4 candidate (R (..., 4, 3, 3), t (..., 4, 3)) with |t| = 1
    (Hartley-Zisserman)."""
    u, _, vt = torch.linalg.svd(e)
    # enforce proper rotations
    u = u * torch.sign(torch.linalg.det(u))[..., None, None]
    vt = vt * torch.sign(torch.linalg.det(vt))[..., None, None]
    w = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=e.dtype, device=e.device)

    def mm3(a, b):   # 3x3 product as broadcast sums, true f32
        return torch.sum(a[..., :, :, None] * b[..., None, :, :], -2)

    r1 = mm3(mm3(u, w), vt)
    r2 = mm3(mm3(u, w.T), vt)
    t = u[..., :, 2]
    return (torch.stack([r1, r1, r2, r2], -3),
            torch.stack([t, -t, t, -t], -2))


def recover_pose(e: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                 mask: torch.Tensor | None = None):
    """Pick the (R, t) candidate with the most points in front of both
    cameras (cheirality), triangulating with each candidate.

    Returns (R (..., 3, 3), t (..., 3), points3d (..., N, 3), n_good (...,)).
    """
    if mask is None:
        mask = torch.ones(x1.shape[:-1], dtype=torch.bool, device=x1.device)
    rs, ts = decompose_essential(e)                      # (.., 4, 3, 3)
    pts = triangulate_points(rs, ts, x1[..., None, :, :],
                             x2[..., None, :, :])        # (.., 4, N, 3)
    z1 = pts[..., 2]
    z2 = torch.sum(rs[..., None, 2, :] * pts, -1) + ts[..., None, 2]
    good = (z1 > 0) & (z2 > 0) & mask[..., None, :]
    counts = good.sum(-1)                                # (.., 4)
    best = torch.argmax(counts, -1)

    def pick(x):
        sel = best.reshape(best.shape + (1,) * (x.ndim - best.ndim))
        sel = sel.expand(best.shape + (1,) + x.shape[best.ndim + 1:])
        return torch.gather(x, best.ndim, sel).squeeze(best.ndim)

    return pick(rs), pick(ts), pick(pts), pick(counts)
