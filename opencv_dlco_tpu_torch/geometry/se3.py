"""SO(3)/SE(3)/Sim(3) Lie-group operations, batched over leading axes.

Port of ``opencv_dlco_tpu/geometry/se3.py``. Poses are (R (..., 3, 3),
t (..., 3)) pairs; tangent vectors are (..., 6) [rho, phi] (translation
part first). Every branch keeps the JAX package's "safe theta" double
``torch.where``: the guarded value never reaches sqrt/division, so forward
derivatives (``torch.func.jacfwd``, which BA and the pose graph take
through these maps) stay finite at the identity, where a single where over
a bare norm would pass a NaN tangent.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zeros, -z, y], -1),
        torch.stack([z, zeros, -x], -1),
        torch.stack([-y, x, zeros], -1),
    ], -2)


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], -1)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3) rotation matrices."""
    th_sq = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = th_sq < _EPS
    th_sq_safe = torch.where(small, torch.ones_like(th_sq), th_sq)
    th = torch.sqrt(th_sq_safe)
    k = hat(phi)
    k2 = torch.matmul(k, k)
    a = torch.where(small, 1.0 - th_sq / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th_sq / 24.0,
                    (1.0 - torch.cos(th)) / th_sq_safe)
    return _eye(phi) + a * k + b * k2


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) rotation vectors (angle in [0, pi]); atan2
    over the guarded antisymmetric part, so it is differentiable at the
    identity, and a symmetric construction near pi."""
    # keep a trailing axis: torch's forward AD promotes a 0-d tensor's
    # tangent to f64 when it meets a Python scalar
    tr = torch.diagonal(r, dim1=-2, dim2=-1).sum(-1, keepdim=True)
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w = vee(r - r.transpose(-1, -2)) * 0.5          # sin(theta) * axis
    sin_sq = torch.sum(w * w, dim=-1, keepdim=True)
    small0 = (sin_sq < _EPS) & (cos > 0.0)          # theta ~ 0
    sin_safe = torch.sqrt(torch.where(small0, torch.ones_like(sin_sq),
                                      sin_sq))
    theta = torch.atan2(sin_safe, cos)
    scale = torch.where(small0, 1.0 + sin_sq / 6.0, theta / sin_safe)
    out_main = w * scale

    near_pi = cos < -0.999
    rr = (r + r.transpose(-1, -2)) * 0.5
    diag = torch.diagonal(rr, dim1=-2, dim2=-1)
    axis_sq = torch.clamp((diag - cos) / (1.0 - cos + _EPS), min=0.0)
    axis = torch.sqrt(axis_sq)
    sign = torch.where(w >= 0, torch.ones_like(w), -torch.ones_like(w))
    w_pi = axis * sign * theta
    return torch.where(near_pi, w_pi, out_main)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    th_sq = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = th_sq < _EPS
    th_sq_safe = torch.where(small, torch.ones_like(th_sq), th_sq)
    th = torch.sqrt(th_sq_safe)
    k = hat(phi)
    k2 = torch.matmul(k, k)
    b = torch.where(small, 0.5 - th_sq / 24.0,
                    (1.0 - torch.cos(th)) / th_sq_safe)
    c = torch.where(small, 1.0 / 6.0 - th_sq / 120.0,
                    (th - torch.sin(th)) / (th_sq_safe * th))
    return _eye(phi) + b * k + c * k2


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x (..., 3) -> (..., 3)."""
    return torch.matmul(m, v[..., None])[..., 0]


def se3_exp(xi: torch.Tensor):
    """(..., 6) [rho, phi] -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return so3_exp(phi), _mv(_so3_left_jacobian(phi), rho)


def se3_log(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> (..., 6) [rho, phi]."""
    phi = so3_log(r)
    j = _so3_left_jacobian(phi)
    rho = torch.linalg.solve(j, t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def se3_compose(r1, t1, r2, t2):
    """(R1, t1) o (R2, t2): x -> R1 (R2 x + t2) + t1."""
    return torch.matmul(r1, r2), _mv(r1, t2) + t1


def se3_inverse(r, t):
    rt = r.transpose(-1, -2)
    return rt, -_mv(rt, t)


def se3_apply(r, t, x):
    """Apply pose to points: (..., 3, 3), (..., 3), (..., N, 3) -> (..., N, 3)."""
    return torch.matmul(x, r.transpose(-1, -2)) + t[..., None, :]


# -- Sim(3): similarity transforms for monocular scale-drift correction ----

def sim3_compose(r1, t1, s1, r2, t2, s2):
    """(R1, t1, s1) o (R2, t2, s2): x -> s1 R1 (s2 R2 x + t2) + t1."""
    s1 = torch.as_tensor(s1, dtype=t1.dtype, device=t1.device)
    return (torch.matmul(r1, r2), s1[..., None] * _mv(r1, t2) + t1,
            s1 * s2)


def sim3_inverse(r, t, s):
    """Inverse of x -> s R x + t."""
    rt = r.transpose(-1, -2)
    s_inv = 1.0 / torch.as_tensor(s, dtype=t.dtype, device=t.device)
    return rt, -s_inv[..., None] * _mv(rt, t), s_inv


def sim3_exp(xi: torch.Tensor):
    """(..., 7) [rho, phi, sigma] -> (R, t, s) small-increment retraction:
    the SE(3) exponential for (R, t) and s = exp(sigma)."""
    r, t = se3_exp(xi[..., :6])
    return r, t, torch.exp(xi[..., 6])
