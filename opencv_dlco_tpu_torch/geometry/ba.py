"""Two-view bundle adjustment with Schur-complement reduction.

Port of ``opencv_dlco_tpu/geometry/ba.py``. The point-block Hessian is
block-diagonal (3x3 per landmark), so each Levenberg-Marquardt step reduces
to a 6x6 camera system:

    S  = Hcc - sum_n Hcp_n Hpp_n^-1 Hcp_n^T
    dc = solve(S, bc - sum_n Hcp_n Hpp_n^-1 bp_n)
    dp_n = Hpp_n^-1 (bp_n - Hcp_n^T dc)

Jacobian blocks are forward-mode derivatives of the per-point residual
(``jacobian.jac_fwd``). Every function takes leading batch axes (the SLAM
pose chunk refines its C pairs in one call); the damping is branchless
per problem, and the LM iterations are a Python loop that returns the
same ``cost_history`` as the reference's ``lax.scan``.

Camera 1 is gauge-fixed to the identity; inputs are normalized coordinates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .jacobian import jac_fwd
from .se3 import _mv, se3_exp


def _point_residual(xi, x3d, r0, t0, obs1, obs2):
    """Residual (..., 4) of landmarks under a left-multiplicative pose
    update xi (..., 6)."""
    dr, dt = se3_exp(xi)
    r2 = torch.matmul(dr, r0)
    t2 = _mv(dr, t0) + dt
    p1 = x3d[..., :2] / x3d[..., 2:3]
    q = _mv(r2, x3d) + t2
    p2 = q[..., :2] / q[..., 2:3]
    return torch.cat([obs1 - p1, obs2 - p2], -1)


def reprojection_residuals(r, t, points, obs1, obs2):
    """(..., N, 4) residuals for metrics (no pose increment)."""
    zero = torch.zeros(points.shape[:-1] + (6,), dtype=points.dtype,
                       device=points.device)
    return _point_residual(zero, points, r[..., None, :, :], t[..., None, :],
                           obs1, obs2)


class BAResult(NamedTuple):
    r: torch.Tensor
    t: torch.Tensor
    points: torch.Tensor
    cost_history: torch.Tensor


def huber_weights(res: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights of the Huber loss: (..., R) residuals -> (...) weights;
    1 inside |r| <= delta, delta/|r| outside."""
    norm = torch.sqrt(torch.sum(res * res, -1) + 1e-12)
    return torch.clamp(delta / norm, max=1.0)


def cauchy_weights(res: torch.Tensor, scale: float) -> torch.Tensor:
    """IRLS weights of the Cauchy (Lorentzian) loss: redescending, gross
    outliers get weight ~ (scale/|r|)^2."""
    sq = torch.sum(res * res, -1)
    return 1.0 / (1.0 + sq / (scale * scale))


def two_view_ba(r0, t0, points0, obs1, obs2, weights=None, *,
                n_iters: int = 12, init_lambda: float = 1e-3,
                robust_delta: float = 0.0) -> BAResult:
    """Jointly refine (R (..., 3, 3), t (..., 3)) and landmarks (..., N, 3);
    returns the LM trajectory's end and its cost history (..., n_iters + 1).

    weights: (..., N) per-landmark weights (0 masks outliers out of the
    normal equations with static shapes). robust_delta > 0 additionally
    applies Cauchy IRLS reweighting per iteration.
    """
    dt_, dev = points0.dtype, points0.device
    if weights is None:
        weights = torch.ones(points0.shape[:-1], dtype=dt_, device=dev)
    w4 = weights[..., None].expand(weights.shape + (4,))
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    eye6 = torch.eye(6, dtype=dt_, device=dev)

    def residual(v, r, t):
        return _point_residual(v[..., :6], v[..., 6:], r, t, obs1, obs2)

    def linearize(r, t, points):
        v0 = torch.cat([torch.zeros(points.shape[:-1] + (6,), dtype=dt_,
                                    device=dev), points], -1)
        res, j = jac_fwd(residual, v0, r[..., None, :, :], t[..., None, :])
        jc, jp = j[..., :6], j[..., 6:]                  # (.., N, 4, 6/3)
        if robust_delta > 0.0:
            w4_eff = w4 * cauchy_weights(res, robust_delta)[..., None]
        else:
            w4_eff = w4
        res_w = res * w4_eff
        jc_w = jc * w4_eff[..., None]
        jp_w = jp * w4_eff[..., None]
        hcc = torch.einsum("...nri,...nrj->...ij", jc_w, jc)
        hpp = torch.einsum("...nri,...nrj->...nij", jp_w, jp)
        hcp = torch.einsum("...nri,...nrj->...nij", jc_w, jp)
        bc = -torch.einsum("...nri,...nr->...i", jc_w, res)
        bp = -torch.einsum("...nri,...nr->...ni", jp_w, res)
        cost = torch.sum(res_w * res, (-2, -1))
        return cost, hcc, hpp, hcp, bc, bp

    def solve_schur(hcc, hpp, hcp, bc, bp, lam):
        tr = torch.diagonal(hpp, dim1=-2, dim2=-1).sum(-1)
        hpp_d = hpp + lam[..., None, None, None] * eye3 * torch.clamp(
            tr / 3.0, min=1e-8)[..., None, None]
        hpp_inv = torch.linalg.inv(hpp_d + 1e-10 * eye3)
        hcc_d = hcc + lam[..., None, None] * torch.diag_embed(
            torch.clamp(torch.diagonal(hcc, dim1=-2, dim2=-1), min=1e-8))
        s = hcc_d - torch.einsum("...nij,...njk,...nlk->...il", hcp, hpp_inv,
                                 hcp)
        rhs = bc - torch.einsum("...nij,...njk,...nk->...i", hcp, hpp_inv, bp)
        dc = torch.linalg.solve(s + 1e-10 * eye6, rhs[..., None])[..., 0]
        dp = torch.einsum("...nij,...nj->...ni", hpp_inv,
                          bp - torch.einsum("...nkj,...k->...nj", hcp, dc))
        return dc, dp

    def cost_at(r, t, points):
        res = reprojection_residuals(r, t, points, obs1, obs2)
        if robust_delta > 0.0:
            rw = cauchy_weights(res, robust_delta)
            return torch.sum(res * res * w4 * rw[..., None], (-2, -1))
        return torch.sum(res * res * w4, (-2, -1))

    r, t, points = r0, t0, points0
    lam = torch.full(r0.shape[:-2], init_lambda, dtype=dt_, device=dev)
    costs = [cost_at(r0, t0, points0)]
    for _ in range(n_iters):
        cost, hcc, hpp, hcp, bc, bp = linearize(r, t, points)
        dc, dp = solve_schur(hcc, hpp, hcp, bc, bp, lam)
        dr_, dt2 = se3_exp(dc)
        r_new = torch.matmul(dr_, r)
        t_new = _mv(dr_, t) + dt2
        p_new = points + dp
        new_cost = cost_at(r_new, t_new, p_new)
        accept = new_cost < cost
        r = torch.where(accept[..., None, None], r_new, r)
        t = torch.where(accept[..., None], t_new, t)
        points = torch.where(accept[..., None, None], p_new, points)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-9, 1e6)
        costs.append(torch.where(accept, new_cost, cost))
    return BAResult(r=r, t=t, points=points,
                    cost_history=torch.stack(costs, -1))
