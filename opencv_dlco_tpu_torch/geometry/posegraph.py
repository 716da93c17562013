"""Pose-graph optimisation over SE(3) and Sim(3) relative-pose constraints.

Port of ``opencv_dlco_tpu/geometry/posegraph.py``.
Levenberg-Marquardt on the product manifold of M poses: each edge
(i, j, Z_ij) contributes the residual

    r_e = log( Z_ij^-1 o (T_i^-1 o T_j) )

with Jacobian blocks by forward mode over left-multiplicative increments on
T_i and T_j. Edge blocks are summed into a dense (6M, 6M) normal system by
deterministic segment sums (``segment.py``; the reference's ``.at[].add``);
node 0 is gauge-fixed by a strong prior. Optional edge-level robust kernels
(Huber, DCS) with a graduated non-convexity anneal, as in the reference.

The ``*_sharded`` solvers are the distributed back end: edges split over
the mesh's ``dp`` axis, each rank builds its part of the normal system
and one all_reduce per Levenberg-Marquardt iteration sums the parts (a
second one sums the candidate's cost); the dense solve and the update are
replicated. A fixed edge partition and world size give the same bits in
every run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel.mesh import data_axis, psum_packed
from .jacobian import jac_fwd
from .se3 import (_mv, se3_compose, se3_exp, se3_inverse, se3_log, so3_log)
from .segment import segment_sum, segment_table


def _huber(chi2, delta2):
    """Edge-level Huber kernel on chi^2 = w |r|^2: (IRLS weight, rho)."""
    safe = torch.clamp(chi2, min=1e-30)
    w = torch.clamp(torch.sqrt(delta2 / safe), max=1.0)
    rho = torch.where(chi2 <= delta2, chi2,
                      2.0 * torch.sqrt(delta2 * safe) - delta2)
    return w, rho


def _dcs(chi2, delta2):
    """Dynamic Covariance Scaling: s = min(1, 2 d^2 / (d^2 + chi^2));
    weight s^2, cost s^2 chi^2 + d^2 (1 - s)^2."""
    s = torch.clamp(2.0 * delta2 / (delta2 + torch.clamp(chi2, min=0.0)),
                    max=1.0)
    return s * s, s * s * chi2 + delta2 * (1.0 - s) ** 2


_ROBUST = {"huber": _huber, "dcs": _dcs}


def _resolve_delta2(chi2_0, weights, robust_delta):
    """d^2 of the robust kernel: the caller's value when > 0, else 4x the
    median initial chi^2 over real (weight > 0) edges (the mean of the two
    middle values for an even count, as jnp.nanmedian)."""
    if robust_delta > 0:
        return torch.clamp(torch.tensor(robust_delta, dtype=chi2_0.dtype,
                                        device=chi2_0.device) ** 2,
                           min=1e-12)
    vals = torch.sort(chi2_0[weights > 0]).values
    n = vals.shape[0]
    med = (0.5 * (vals[(n - 1) // 2] + vals[n // 2]) if n
           else torch.zeros((), dtype=chi2_0.dtype, device=chi2_0.device))
    return torch.clamp(4.0 * med, min=1e-12)


_GNC_BASE = 4.0


def _gnc_scale(k: int, gnc_iters: int) -> float:
    """Graduated non-convexity schedule: d^2_k = d^2 * 4^max(gnc_iters - k,
    0), annealed to the nominal width; one d^2_k per LM step, so the accept
    test compares one objective."""
    return _GNC_BASE ** max(gnc_iters - k, 0)


def _edge_residual(xi, r_i, t_i, r_j, t_j, r_z, t_z):
    """(..., 6) residual of edges under increments xi = [xi_i, xi_j]."""
    dri, dti = se3_exp(xi[..., :6])
    drj, dtj = se3_exp(xi[..., 6:])
    ri, ti = se3_compose(dri, dti, r_i, t_i)
    rj, tj = se3_compose(drj, dtj, r_j, t_j)
    r_rel, t_rel = se3_compose(*se3_inverse(ri, ti), rj, tj)
    r_err, t_err = se3_compose(*se3_inverse(r_z, t_z), r_rel, t_rel)
    return se3_log(r_err, t_err)


class PoseGraphResult(NamedTuple):
    r: torch.Tensor            # (M, 3, 3)
    t: torch.Tensor            # (M, 3)
    cost_history: torch.Tensor


def _assemble(res, ja, jb, weights, seg_h, seg_b):
    """The edge blocks' normal system: H as (m * m, dof, dof) blocks and
    b (m, dof), summed by the segment tables of ``_edge_segments`` (a
    fixed order, so the same inputs give the same system in every run)."""
    w = weights[:, None, None]
    haa = w * torch.einsum("eri,erj->eij", ja, ja)
    hbb = w * torch.einsum("eri,erj->eij", jb, jb)
    hab = w * torch.einsum("eri,erj->eij", ja, jb)
    ba = -torch.einsum("e,eri,er->ei", weights, ja, res)
    bb = -torch.einsum("e,eri,er->ei", weights, jb, res)
    blocks = torch.cat([haa, hbb, hab, hab.transpose(-1, -2)])
    return (segment_sum(blocks, seg_h),
            segment_sum(torch.cat([ba, bb]), seg_b))


def _dense(h, b, m, dof, gauge_weight):
    """(H (dof m, dof m), b (dof m,)) with the gauge prior on node 0."""
    h[0] = h[0] + gauge_weight * torch.eye(dof, dtype=h.dtype,
                                           device=h.device)
    hd = h.reshape(m, m, dof, dof).permute(0, 2, 1, 3).reshape(dof * m,
                                                              dof * m)
    return hd, b.reshape(-1)


def _edge_block(mesh, e: int):
    """This dp rank's contiguous block of E edges (ceil(E / dp) a rank, the
    last ones short) and that block length."""
    per = -(-e // mesh.shape[data_axis])
    k = mesh.axis_index(data_axis)
    return slice(min(k * per, e), min((k + 1) * per, e)), per


def _edge_segments(edges_i, edges_j, m):
    """Segment tables of ``_assemble``: the four blocks of each edge by
    linear block index (ii, jj, ij, ji), and the two gradient blocks by
    node."""
    lin = torch.cat([edges_i * m + edges_i, edges_j * m + edges_j,
                     edges_i * m + edges_j, edges_j * m + edges_i])
    return (segment_table(lin, m * m),
            segment_table(torch.cat([edges_i, edges_j]), m))


def _lm(state0, residuals, apply_dx, weights, edges_i, edges_j, m, dof,
        n_iters, init_lambda, gauge_weight, robust, robust_delta,
        gnc_iters, mesh=None, per=0):
    """The LM loop shared by the SE(3) and Sim(3) solvers. With ``mesh``
    the edges are this rank's block (``per`` the longest block) and the
    normal system and costs are summed over dp."""
    dt, dev = weights.dtype, weights.device
    rho_fn = _ROBUST.get(robust)
    delta2 = None
    if robust != "none":
        res0 = residuals(state0, None)
        chi2_0, w_all = weights * torch.sum(res0 * res0, 1), weights
        if mesh is not None:
            # the median over every real edge: blocks padded with weight 0
            pad = per - chi2_0.shape[0]
            chi2_0, w_all = (mesh.all_gather(torch.cat(
                [x, x.new_zeros(pad)]), data_axis) for x in (chi2_0, w_all))
        delta2 = _resolve_delta2(chi2_0, w_all, robust_delta)

    def cost_and_weights(res, d2_k):
        chi2 = weights * torch.sum(res * res, 1)
        if rho_fn is None:
            return chi2.sum(), weights
        rw, rho = rho_fn(chi2, d2_k)
        return rho.sum(), weights * rw

    eye = torch.eye(dof * m, dtype=dt, device=dev)
    seg_h, seg_b = _edge_segments(edges_i, edges_j, m)
    state = state0
    lam = torch.tensor(init_lambda, dtype=dt, device=dev)
    cost0, _ = cost_and_weights(residuals(state0, None), delta2)
    costs = [psum_packed(mesh, data_axis, cost0)[0]]
    for k in range(n_iters):
        d2_k = delta2 * _gnc_scale(k, gnc_iters) if rho_fn else None
        res, j = residuals(state, True)
        cost, w_eff = cost_and_weights(res, d2_k)
        h, b = _assemble(res, j[..., :dof], j[..., dof:], w_eff, seg_h,
                         seg_b)
        h, b, cost = psum_packed(mesh, data_axis, h, b, cost)
        hd, b = _dense(h, b, m, dof, gauge_weight)
        hd = hd + lam * torch.diag(torch.clamp(torch.diagonal(hd), min=1e-8))
        dx = torch.linalg.solve(hd + 1e-9 * eye, b[:, None])[:, 0]
        new = apply_dx(state, dx.reshape(m, dof))
        new_cost, _ = cost_and_weights(residuals(new, None), d2_k)
        new_cost = psum_packed(mesh, data_axis, new_cost)[0]
        accept = new_cost < cost
        state = tuple(torch.where(accept, a, s) for a, s in zip(new, state))
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-9, 1e6)
        costs.append(torch.where(accept, new_cost, cost))
    return state, torch.stack(costs)


def _edges(edges_i, edges_j, dev):
    return (torch.as_tensor(edges_i, device=dev).long(),
            torch.as_tensor(edges_j, device=dev).long())


def optimize_pose_graph(r0, t0, edges_i, edges_j, r_z, t_z,
                        weights=None, *, n_iters: int = 15,
                        init_lambda: float = 1e-4,
                        gauge_weight: float = 1e6,
                        robust: str = "none",
                        robust_delta: float = 0.0,
                        gnc_iters: int = 0) -> PoseGraphResult:
    """Optimise M poses (r0 (M, 3, 3), t0 (M, 3), world_T_node) given E
    measured i_T_j relative poses (edges_i, edges_j (E,), r_z (E, 3, 3),
    t_z (E, 3)) and edge weights (E,). ``robust``: "none" | "huber" |
    "dcs", IRLS weights recomputed at every linearization; robust_delta
    <= 0 picks the width from the median initial edge chi^2; gnc_iters
    anneals the width over the first iterations."""
    return _se3_graph(None, r0, t0, edges_i, edges_j, r_z, t_z, weights,
                      n_iters, init_lambda, gauge_weight, robust,
                      robust_delta, gnc_iters)


def optimize_pose_graph_sharded(mesh, r0, t0, edges_i, edges_j, r_z, t_z,
                                weights=None, *, n_iters: int = 15,
                                init_lambda: float = 1e-4,
                                gauge_weight: float = 1e6,
                                robust: str = "none",
                                robust_delta: float = 0.0,
                                gnc_iters: int = 0) -> PoseGraphResult:
    """optimize_pose_graph with the edges split over the mesh's dp axis.
    Every rank passes the whole graph (as the JAX package's jitted
    solver takes it) and linearizes its own block of edges; the result is
    the same on every rank."""
    return _se3_graph(mesh, r0, t0, edges_i, edges_j, r_z, t_z, weights,
                      n_iters, init_lambda, gauge_weight, robust,
                      robust_delta, gnc_iters)


def _se3_graph(mesh, r0, t0, edges_i, edges_j, r_z, t_z, weights, n_iters,
               init_lambda, gauge_weight, robust, robust_delta, gnc_iters):
    dev = t0.device
    m = r0.shape[0]
    ei, ej = _edges(edges_i, edges_j, dev)
    if weights is None:
        weights = torch.ones(ei.shape[0], dtype=t0.dtype, device=dev)
    per = 0
    if mesh is not None:
        blk, per = _edge_block(mesh, ei.shape[0])
        ei, ej, r_z, t_z, weights = (x[blk] for x in
                                     (ei, ej, r_z, t_z, weights))
    zero = torch.zeros((ei.shape[0], 12), dtype=t0.dtype, device=dev)

    def residuals(state, with_jac):
        r, t = state
        args = (r[ei], t[ei], r[ej], t[ej], r_z, t_z)
        if with_jac:
            return jac_fwd(_edge_residual, zero, *args)
        return _edge_residual(zero, *args)

    def apply_dx(state, dx):
        dr, dt = se3_exp(dx)
        return se3_compose(dr, dt, *state)

    (r, t), costs = _lm((r0, t0), residuals, apply_dx, weights, ei, ej, m, 6,
                        n_iters, init_lambda, gauge_weight, robust,
                        robust_delta, gnc_iters, mesh, per)
    return PoseGraphResult(r=r, t=t, cost_history=costs)


# -- Sim(3) pose graph: monocular scale-drift-aware loop closure -----------

def _sim3_edge_residual(xi, r_i, t_i, s_i, r_j, t_j, s_j, r_z, t_z, s_z,
                        sw):
    """(..., 7) residual of edges under Sim(3) increments xi = [xi_i,
    xi_j] (7 each). Scales ride as (..., 1) so no tensor in the forward-mode
    pass is 0-d. The log-scale component is weighted by ``sw``."""
    def exp7(x):
        r, t = se3_exp(x[..., :6])
        return r, t, torch.exp(x[..., 6:7])

    def compose(a, b):
        return (torch.matmul(a[0], b[0]), a[2] * _mv(a[0], b[1]) + a[1],
                a[2] * b[2])

    def inverse(a):
        rt = a[0].transpose(-1, -2)
        s_inv = 1.0 / a[2]
        return rt, -s_inv * _mv(rt, a[1]), s_inv

    ti = compose(exp7(xi[..., :7]), (r_i, t_i, s_i))
    tj = compose(exp7(xi[..., 7:]), (r_j, t_j, s_j))
    r_err, t_err, s_err = compose(inverse((r_z, t_z, s_z)),
                                  compose(inverse(ti), tj))
    return torch.cat([t_err, so3_log(r_err), sw * torch.log(s_err)], -1)


class Sim3PoseGraphResult(NamedTuple):
    r: torch.Tensor            # (M, 3, 3)
    t: torch.Tensor            # (M, 3)
    s: torch.Tensor            # (M,) per-node scale corrections
    cost_history: torch.Tensor


def optimize_pose_graph_sim3(r0, t0, edges_i, edges_j, r_z, t_z,
                             weights=None, s_z=None, *, n_iters: int = 20,
                             init_lambda: float = 1e-4,
                             gauge_weight: float = 1e6,
                             scale_weight: float = 0.1,
                             robust: str = "none",
                             robust_delta: float = 0.0,
                             gnc_iters: int = 0
                             ) -> Sim3PoseGraphResult:
    """optimize_pose_graph over Sim(3): per-node scales absorb monocular
    scale drift; node 0 is gauge-fixed in all 7 dof. ``s_z`` (E,) are the
    edges' relative-scale measurements (None: all 1). The returned (r, t)
    have the scale corrections folded in; ``s`` is for diagnostics."""
    return _sim3_graph(None, r0, t0, edges_i, edges_j, r_z, t_z, weights,
                       s_z, n_iters, init_lambda, gauge_weight, scale_weight,
                       robust, robust_delta, gnc_iters)


def optimize_pose_graph_sim3_sharded(mesh, r0, t0, edges_i, edges_j, r_z,
                                     t_z, weights=None, s_z=None, *,
                                     n_iters: int = 20,
                                     init_lambda: float = 1e-4,
                                     gauge_weight: float = 1e6,
                                     scale_weight: float = 0.1,
                                     robust: str = "none",
                                     robust_delta: float = 0.0,
                                     gnc_iters: int = 0
                                     ) -> Sim3PoseGraphResult:
    """optimize_pose_graph_sim3 with the edges split over the dp axis
    (see optimize_pose_graph_sharded)."""
    return _sim3_graph(mesh, r0, t0, edges_i, edges_j, r_z, t_z, weights,
                       s_z, n_iters, init_lambda, gauge_weight, scale_weight,
                       robust, robust_delta, gnc_iters)


def _sim3_graph(mesh, r0, t0, edges_i, edges_j, r_z, t_z, weights, s_z,
                n_iters, init_lambda, gauge_weight, scale_weight, robust,
                robust_delta, gnc_iters):
    dev, dt = t0.device, t0.dtype
    m = r0.shape[0]
    ei, ej = _edges(edges_i, edges_j, dev)
    e = ei.shape[0]
    if weights is None:
        weights = torch.ones(e, dtype=dt, device=dev)
    if s_z is None:
        s_z = torch.ones(e, dtype=dt, device=dev)
    s_z = torch.as_tensor(s_z, dtype=dt, device=dev)[:, None]
    per = 0
    if mesh is not None:
        blk, per = _edge_block(mesh, e)
        ei, ej, r_z, t_z, weights, s_z = (x[blk] for x in
                                          (ei, ej, r_z, t_z, weights, s_z))
    zero = torch.zeros((ei.shape[0], 14), dtype=dt, device=dev)
    sw = float(scale_weight)

    def residuals(state, with_jac):
        r, t, s = state
        args = (r[ei], t[ei], s[ei], r[ej], t[ej], s[ej], r_z, t_z, s_z, sw)
        if with_jac:
            return jac_fwd(_sim3_edge_residual, zero, *args)
        return _sim3_edge_residual(zero, *args)

    def apply_dx(state, dx):
        r, t, s = state
        dr, dt_ = se3_exp(dx[:, :6])
        ds = torch.exp(dx[:, 6:7])
        return (torch.matmul(dr, r), ds * _mv(dr, t) + dt_, ds * s)

    s0 = torch.ones((m, 1), dtype=dt, device=dev)
    (r, t, s), costs = _lm((r0, t0, s0), residuals, apply_dx, weights, ei,
                           ej, m, 7, n_iters, init_lambda, gauge_weight,
                           robust, robust_delta, gnc_iters, mesh, per)
    return Sim3PoseGraphResult(r=r, t=t, s=s[:, 0], cost_history=costs)
