"""Batched linear (DLT) triangulation.

Port of ``opencv_dlco_tpu/geometry/triangulate.py``. Camera 1 is the
identity [I | 0]; camera 2 is [R | t]; inputs are normalized camera
coordinates. Each point solves its 4x3 least-squares system through the
normal equations, one batched (..., N, 3, 3) solve.
"""

from __future__ import annotations

import torch


def triangulate_points(r: torch.Tensor, t: torch.Tensor,
                       x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3), (..., N, 2), (..., N, 2) -> (..., N, 3) points
    in the camera-1 frame."""
    dt, dev = x1.dtype, x1.device
    p1 = torch.cat([torch.eye(3, dtype=dt, device=dev),
                    torch.zeros((3, 1), dtype=dt, device=dev)], 1)
    p2 = torch.cat([r, t[..., :, None]], -1)

    def rows(p, x):
        # x * p[2] - p[0], y * p[2] - p[1] per point: (..., N, 2, 4)
        p = p[..., None, :, :]
        return torch.stack([x[..., 0:1] * p[..., 2, :] - p[..., 0, :],
                            x[..., 1:2] * p[..., 2, :] - p[..., 1, :]], -2)

    a = torch.cat(torch.broadcast_tensors(rows(p1, x1), rows(p2, x2)),
                  -2)                                     # (..., N, 4, 4)
    b_mat = a[..., :3]
    b_vec = -a[..., 3]
    # true-f32 normal equations as broadcast sums, like the reference
    ata = torch.sum(b_mat[..., :, :, None] * b_mat[..., :, None, :], -3)
    atb = torch.sum(b_mat * b_vec[..., None], -2)
    ata = ata + 1e-10 * torch.eye(3, dtype=dt, device=dev)
    return torch.linalg.solve(ata, atb[..., None])[..., 0]
