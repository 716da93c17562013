"""Shi-Tomasi/Harris keypoint detection and patch extraction, batched.

Port of ``opencv_dlco_tpu/ops/detect.py``, the SLAM front end's detect step.
Gradients and the structure-tensor smoothing are the descriptor's dense
operator matmuls (f32, TF32 off); non-maximum suppression is a max-pool
equality test (``max_pool2d`` pads with -inf, the reference's "SAME"
``reduce_window``); "a variable number of keypoints" is a fixed top-k with
a validity mask, equal scores ordered by the lower flat index as
``lax.top_k`` orders them (a stable descending sort).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .patch_transform import blur_matrix, gradient_matrix


def corner_response(image: torch.Tensor, *, harris_k: float = 0.04,
                    sigma: float = 2.0,
                    use_shi_tomasi: bool = True) -> torch.Tensor:
    """(B, H, W) f32 images -> (B, H, W) structure-tensor response: the
    smaller eigenvalue (Shi-Tomasi) or det - k tr^2 (Harris)."""
    h, w = image.shape[-2:]
    dev = image.device
    gy = torch.from_numpy(gradient_matrix(h)).to(dev)
    gx = torch.from_numpy(gradient_matrix(w)).to(dev)
    ix = torch.matmul(image, gx.T)
    iy = torch.matmul(gy, image)
    by = torch.from_numpy(blur_matrix(h, sigma)).to(dev)
    bx = torch.from_numpy(blur_matrix(w, sigma)).to(dev)

    def smooth(a):
        return torch.matmul(by, torch.matmul(a, bx.T))

    sxx = smooth(ix * ix)
    syy = smooth(iy * iy)
    sxy = smooth(ix * iy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    if use_shi_tomasi:
        return 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4.0 * det,
                                                  min=0.0)))
    return det - harris_k * tr * tr


def detect_corners(image: torch.Tensor, k: int = 512, *, nms_radius: int = 4,
                   border: int = 32, harris_k: float = 0.04,
                   sigma: float = 2.0, use_shi_tomasi: bool = True,
                   subpixel: bool = False):
    """(..., H, W) image(s) -> (scores (..., k), yx (..., k, 2) int32,
    valid (..., k)), and with ``subpixel`` a fourth output yx_f (..., k, 2)
    f32: the per-axis parabolic refinement of each maximum (offset clamped
    to +-0.5 px).

    Corners are NMS-filtered local maxima of the structure-tensor response
    outside a ``border`` margin (so a full patch fits around each)."""
    img = image.to(torch.float32)
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    img = img.reshape((-1, h, w))
    dev = img.device
    resp = corner_response(img, harris_k=harris_k, sigma=sigma,
                           use_shi_tomasi=use_shi_tomasi)

    # NMS: keep pixels equal to their neighbourhood max
    win = 2 * nms_radius + 1
    local_max = F.max_pool2d(resp[:, None], win, stride=1,
                             padding=nms_radius)[:, 0]
    keep = resp >= local_max
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    in_border = ((ys >= border) & (ys < h - border)
                 & (xs >= border) & (xs < w - border))
    score = torch.where(keep & in_border, resp,
                        torch.full_like(resp, float("-inf")))

    flat = score.reshape(score.shape[0], -1)
    top, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    yx = torch.stack([idx // w, idx % w], -1).to(torch.int32)
    valid = torch.isfinite(top) & (top > 0)

    def out(*xs_):
        return tuple(x.reshape(lead + x.shape[1:]) for x in xs_)

    if not subpixel:
        return out(top, yx, valid)

    # 1-D parabola per axis on the raw response: off = -0.5 (r+ - r-) /
    # (r+ - 2 r0 + r-)
    flat_resp = resp.reshape(resp.shape[0], -1)
    yl, xl = yx[..., 0].long(), yx[..., 1].long()

    def at(dy, dx):
        return torch.gather(flat_resp, 1, torch.clamp(yl + dy, 0, h - 1) * w
                            + torch.clamp(xl + dx, 0, w - 1))

    r0 = at(0, 0)
    denom_y = at(1, 0) - 2.0 * r0 + at(-1, 0)
    denom_x = at(0, 1) - 2.0 * r0 + at(0, -1)
    zero = torch.zeros_like(r0)
    off_y = torch.where(denom_y.abs() > 1e-12,
                        -0.5 * (at(1, 0) - at(-1, 0)) / denom_y, zero)
    off_x = torch.where(denom_x.abs() > 1e-12,
                        -0.5 * (at(0, 1) - at(0, -1)) / denom_x, zero)
    off = torch.clamp(torch.stack([off_y, off_x], -1), -0.5, 0.5)
    return out(top, yx, valid, yx.to(torch.float32) + off)


def extract_patches(image: torch.Tensor, yx: torch.Tensor,
                    patch_size: int = 64) -> torch.Tensor:
    """Crop patch_size^2 windows centred on each (y, x): (..., H, W) and
    (..., K, 2) -> (..., K, P, P) f32. Window starts follow
    ``lax.dynamic_slice``: a negative start counts from the end, then the
    window is clamped inside the image (the detector's border keeps every
    valid centre >= patch_size // 2 from the edge; only the invalid slots'
    windows are moved)."""
    img = image.to(torch.float32)
    h, w = img.shape[-2:]
    half = patch_size // 2
    ar = torch.arange(patch_size, device=img.device)

    def start(c, n):
        s = c.long() - half
        return torch.clamp(torch.where(s < 0, s + n, s), 0, n - patch_size)

    y0 = start(yx[..., 0], h)
    x0 = start(yx[..., 1], w)
    rows = (y0[..., None] + ar)[..., :, None]            # (..., K, P, 1)
    cols = (x0[..., None] + ar)[..., None, :]            # (..., K, 1, P)
    lin = (rows * w + cols).reshape(yx.shape[:-2] + (-1,))
    flat = img.reshape(img.shape[:-2] + (h * w,))
    return torch.gather(flat, -1, lin).reshape(
        yx.shape[:-1] + (patch_size, patch_size))
