"""Multi-view bundle adjustment with Schur-complement reduction.

Port of ``opencv_dlco_tpu/geometry/mvba.py``. M keyframe poses, N
landmarks, K observations; per Levenberg-Marquardt step:

  1. per-observation residuals and Jacobian blocks J_c (2, 6) wrt the
     observing camera and J_p (2, 3) wrt the landmark (forward mode);
  2. block Hessians Hcc (M, 6, 6), Hpp (N, 3, 3) summed per camera and
     per landmark, and the per-observation coupling blocks Hcp (K, 6, 3);
  3. landmark elimination with the observations grouped per landmark (the
     static-width ``table``): S = Hcc - sum_p W_p Hpp_p^-1 W_p^T, as
     (L, L) camera-pair outer products summed into (M, M, 6, 6);
  4. a dense (6M, 6M) solve and landmark back-substitution.

Every sum over observations is a deterministic segment sum
(``segment.py``; the reference's ``.at[].add``), not ``index_add``, whose
float atomics on the card made the refined trajectory differ from run to
run. The segment tables depend only on the index arrays and are built
once per solve (``_Segments``).

Distribution (``multi_view_ba_sharded``): landmarks and their
observations shard over the mesh's ``dp`` axis (``shard_ba_problem``);
each rank reduces its landmarks' contribution to (S, rhs), one all_reduce
sums them (with the cost), every rank solves the 6M system, and the
back-substitution stays local to each landmark shard; a second
all_reduce sums the candidate's cost.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..parallel.mesh import data_axis, psum_packed
from .jacobian import jac_fwd
from .se3 import _mv, se3_exp
from .segment import segment_sum, segment_table


def _obs_residual(xi, x3d, r0, t0, uv):
    """(..., 2) reprojection residual under a left pose increment."""
    dr, dt = se3_exp(xi)
    r = torch.matmul(dr, r0)
    t = _mv(dr, t0) + dt
    q = _mv(r, x3d) + t
    return uv - q[..., :2] / q[..., 2:3]


def build_landmark_table(pt_idx: np.ndarray, n_landmarks: int,
                         max_obs: Optional[int] = None):
    """Group observation indices by landmark into a padded (N, L) table.

    Returns (table (N, L) int32 with -1 padding, L). Host-side numpy, as in
    the reference."""
    lists = [[] for _ in range(n_landmarks)]
    for k, p in enumerate(np.asarray(pt_idx)):
        lists[p].append(k)
    width = max(len(l) for l in lists) if lists else 1
    if max_obs is not None:
        width = min(width, max_obs)
    table = np.full((n_landmarks, width), -1, np.int32)
    for p, l in enumerate(lists):
        take = l[:width]
        table[p, :len(take)] = take
    return table, width


class MVBAResult(NamedTuple):
    r: torch.Tensor           # (M, 3, 3)
    t: torch.Tensor           # (M, 3)
    points: torch.Tensor      # (N, 3)
    cost_history: torch.Tensor


def _residuals(r, t, points, cam_idx, pt_idx, uv):
    zero = torch.zeros(uv.shape[:-1] + (6,), dtype=uv.dtype,
                       device=uv.device)
    return _obs_residual(zero, points[pt_idx], r[cam_idx], t[cam_idx], uv)


def _linearize(r, t, points, cam_idx, uv, w, pt_idx):
    v0 = torch.cat([torch.zeros(uv.shape[:-1] + (6,), dtype=uv.dtype,
                                device=uv.device), points[pt_idx]], -1)
    res, j = jac_fwd(lambda v, rc, tc: _obs_residual(v[..., :6], v[..., 6:],
                                                     rc, tc, uv),
                     v0, r[cam_idx], t[cam_idx])
    cost = torch.sum(w[:, None] * res * res)
    return res, j[..., :6], j[..., 6:], cost


class _Segments(NamedTuple):
    """Segment tables of one solve: observations by camera (cam) and by
    landmark (pt), the valid (L, L) camera pairs of each landmark by
    linear block index c_i * M + c_j (pair), and the valid table slots by
    camera (slot)."""
    cam: torch.Tensor
    pt: torch.Tensor
    pair: torch.Tensor
    slot: torch.Tensor

    @classmethod
    def build(cls, cam_idx, pt_idx, table, m, n):
        valid = table >= 0
        cams = cam_idx[torch.clamp(table, min=0)]
        vv = valid[:, :, None] & valid[:, None, :]
        lin = torch.where(vv, cams[:, :, None] * m + cams[:, None, :], -1)
        return cls(cam=segment_table(cam_idx, m),
                   pt=segment_table(pt_idx, n),
                   pair=segment_table(lin, m * m),
                   slot=segment_table(torch.where(valid, cams, -1), m))


def _schur_terms(res, jc, jp, w, table, seg, m, lam):
    """The reduced camera system: (S (M, M, 6, 6), rhs (M, 6), hpp_inv
    (N, 3, 3), bp (N, 3), hcp_blocks (K, 6, 3)); landmark blocks damped
    here, camera damping and the gauge prior left to the caller."""
    dt, dev = res.dtype, res.device
    wk = w[:, None, None]
    hcc_blocks = wk * torch.einsum("kri,krj->kij", jc, jc)
    hpp_blocks = wk * torch.einsum("kri,krj->kij", jp, jp)
    hcp_blocks = wk * torch.einsum("kri,krj->kij", jc, jp)
    bc_obs = -torch.einsum("k,kri,kr->ki", w, jc, res)
    bp_obs = -torch.einsum("k,kri,kr->ki", w, jp, res)

    hpp = segment_sum(hpp_blocks, seg.pt)
    bp = segment_sum(bp_obs, seg.pt)
    hcc = segment_sum(hcc_blocks, seg.cam)
    bc = segment_sum(bc_obs, seg.cam)

    # damp landmark blocks then invert (3x3, batched)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    tr = torch.diagonal(hpp, dim1=-2, dim2=-1).sum(-1)
    hpp_d = hpp + lam * eye3 * torch.clamp(tr / 3.0, min=1e-8)[:, None, None]
    hpp_inv = torch.linalg.inv(hpp_d + 1e-10 * eye3)

    # per-landmark elimination over that landmark's (padded) observations
    valid = table >= 0                                     # (N, L)
    tbl = torch.clamp(table, min=0)
    w_blk = hcp_blocks[tbl] * valid[..., None, None]       # (N, L, 6, 3)
    tmp = torch.einsum("nlij,njk->nlik", w_blk, hpp_inv)
    pair = torch.einsum("nlik,nmjk->nlmij", tmp, w_blk)    # (N, L, L, 6, 6)
    rhs_corr = torch.einsum("nlik,nk->nli", tmp, bp)       # (N, L, 6)

    s = -segment_sum(pair.reshape(-1, 6, 6), seg.pair).reshape(m, m, 6, 6)
    ar = torch.arange(m, device=dev)
    s[ar, ar] = hcc + s[ar, ar]
    rhs = bc - segment_sum(rhs_corr.reshape(-1, 6), seg.slot)
    return s, rhs, hpp_inv, bp, hcp_blocks


def _solve_and_backsub(s, rhs, hpp_inv, bp, hcp_blocks, seg, cam_idx, m):
    sd = s.permute(0, 2, 1, 3).reshape(6 * m, 6 * m)
    eye = torch.eye(6 * m, dtype=s.dtype, device=s.device)
    dc = torch.linalg.solve(sd + 1e-9 * eye,
                            rhs.reshape(-1, 1))[:, 0].reshape(m, 6)
    # back-substitute: dp_n = Hpp_n^-1 (bp_n - sum_obs Hcp_k^T dc_cam(k))
    corr = torch.einsum("kij,ki->kj", hcp_blocks, dc[cam_idx])  # (K, 3)
    bp_corr = bp - segment_sum(corr, seg.pt)
    dp = torch.einsum("nij,nj->ni", hpp_inv, bp_corr)
    return dc, dp


def shard_ba_problem(points0, cam_idx, pt_idx, uv, weights,
                     n_shards: int):
    """Partition a BA problem by landmark into n_shards equal pieces
    (host-side numpy, as in the JAX package).

    Observations follow their landmark (each obs belongs to exactly one);
    both landmarks and observations are padded per shard (padding obs get
    weight 0 and point at local landmark 0 / camera 0). Returns a dict of
    stacked per-shard arrays (leading axis: the shard) plus the landmark
    count and the landmarks per shard."""
    points0 = np.asarray(points0)
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv)
    weights = np.asarray(weights)
    n = points0.shape[0]

    # landmarks partitioned contiguously
    n_pad = (-n) % n_shards
    n_per = (n + n_pad) // n_shards
    shard_of_landmark = np.minimum(np.arange(n + n_pad) // n_per,
                                   n_shards - 1)
    obs_shard = shard_of_landmark[pt_idx]
    k_per = max(int(np.max(np.bincount(obs_shard, minlength=n_shards))), 1)

    pts_sh = np.zeros((n_shards, n_per, 3), points0.dtype)
    cam_sh = np.zeros((n_shards, k_per), np.int32)
    loc_pt_sh = np.zeros((n_shards, k_per), np.int32)
    uv_sh = np.zeros((n_shards, k_per, 2), uv.dtype)
    w_sh = np.zeros((n_shards, k_per), weights.dtype)
    tables = []
    width = 0
    for s in range(n_shards):
        lms = np.arange(s * n_per, min((s + 1) * n_per, n))
        pts_sh[s, :len(lms)] = points0[lms]
        sel = np.flatnonzero(obs_shard == s)
        cam_sh[s, :len(sel)] = cam_idx[sel]
        loc_pt_sh[s, :len(sel)] = pt_idx[sel] - s * n_per
        uv_sh[s, :len(sel)] = uv[sel]
        w_sh[s, :len(sel)] = weights[sel]
        tbl, wd = build_landmark_table(loc_pt_sh[s, :len(sel)], n_per)
        tables.append(tbl)
        width = max(width, wd)
    table_sh = np.full((n_shards, n_per, width), -1, np.int32)
    for s, tbl in enumerate(tables):
        table_sh[s, :, :tbl.shape[1]] = tbl
    return dict(points=pts_sh, cam_idx=cam_sh, pt_idx=loc_pt_sh, uv=uv_sh,
                weights=w_sh, table=table_sh, n_landmarks=n, n_per=n_per)


def multi_view_ba(r0, t0, points0, cam_idx, pt_idx, uv, table,
                  weights=None, *, n_iters: int = 10,
                  init_lambda: float = 1e-3,
                  gauge_weight: float = 1e6) -> MVBAResult:
    """Single-device multi-view BA. r0 (M, 3, 3), t0 (M, 3), points0
    (N, 3); per observation cam_idx, pt_idx (K,) and uv (K, 2); table
    (N, L) from build_landmark_table (numpy or tensor)."""
    return _mvba(None, r0, t0, points0, cam_idx, pt_idx, uv, table,
                 weights, n_iters, init_lambda, gauge_weight)


def multi_view_ba_sharded(mesh, r0, t0, sharded, *, n_iters: int = 10,
                          init_lambda: float = 1e-3,
                          gauge_weight: float = 1e6) -> MVBAResult:
    """Landmark-sharded multi-view BA over the mesh's ``dp`` axis.

    ``sharded``: this rank's shard of shard_ba_problem's output — each of
    its arrays at this rank's dp index (points (n_per, 3), cam_idx,
    pt_idx, weights (k_per,), uv (k_per, 2), table (n_per, L)); r0, t0
    are every rank's (replicated). Returns the replicated poses and this
    rank's landmarks (n_per, 3)."""
    dev = t0.device

    def arr(name, dtype):
        return torch.as_tensor(np.asarray(sharded[name]), dtype=dtype,
                               device=dev)

    return _mvba(mesh, r0, t0, arr("points", t0.dtype),
                 arr("cam_idx", torch.int64), arr("pt_idx", torch.int64),
                 arr("uv", t0.dtype), arr("table", torch.int64),
                 arr("weights", t0.dtype), n_iters, init_lambda,
                 gauge_weight)


def _mvba(mesh, r0, t0, points0, cam_idx, pt_idx, uv, table, weights,
          n_iters, init_lambda, gauge_weight) -> MVBAResult:
    """The LM loop of multi_view_ba; with ``mesh``, the (S, rhs) system
    and the costs are summed over dp."""
    dt, dev = points0.dtype, points0.device
    m = r0.shape[0]
    cam_idx = torch.as_tensor(cam_idx, device=dev).long()
    pt_idx = torch.as_tensor(pt_idx, device=dev).long()
    table = torch.as_tensor(table, device=dev).long()
    if weights is None:
        weights = torch.ones(uv.shape[0], dtype=uv.dtype, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    ar = torch.arange(m, device=dev)
    seg = _Segments.build(cam_idx, pt_idx, table, m, points0.shape[0])

    def cost_of(r, t, points):
        res = _residuals(r, t, points, cam_idx, pt_idx, uv)
        cost = torch.sum(weights[:, None] * res * res)
        return psum_packed(mesh, data_axis, cost)[0]

    r, t, points = r0, t0, points0
    lam = torch.tensor(init_lambda, dtype=dt, device=dev)
    costs = [cost_of(r0, t0, points0)]
    for _ in range(n_iters):
        res, jc, jp, cost = _linearize(r, t, points, cam_idx, uv, weights,
                                       pt_idx)
        s, rhs, hpp_inv, bp, hcp_b = _schur_terms(
            res, jc, jp, weights, table, seg, m, lam)
        s, rhs, cost = psum_packed(mesh, data_axis, s, rhs, cost)
        s = s.clone()
        s[0, 0] = s[0, 0] + gauge_weight * eye6
        tr = torch.diagonal(s[ar, ar], dim1=-2, dim2=-1).sum(-1)
        s[ar, ar] = s[ar, ar] + lam * eye6 * torch.clamp(
            tr / 6.0, min=1e-8)[:, None, None]
        dc, dp = _solve_and_backsub(s, rhs, hpp_inv, bp, hcp_b, seg,
                                    cam_idx, m)
        dr, dt2 = se3_exp(dc)
        r_new = torch.matmul(dr, r)
        t_new = _mv(dr, t) + dt2
        p_new = points + dp
        new_cost = cost_of(r_new, t_new, p_new)
        accept = new_cost < cost
        r = torch.where(accept, r_new, r)
        t = torch.where(accept, t_new, t)
        points = torch.where(accept, p_new, points)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-9, 1e6)
        costs.append(torch.where(accept, new_cost, cost))
    return MVBAResult(r=r, t=t, points=points,
                      cost_history=torch.stack(costs))
