"""Projection learner: trace-norm-regularised hinge RDA with PSD projection.

Port of ``opencv_dlco_tpu/models/pj_rda.py`` (reference:
src/pj-learn.cpp:305-589). Per iteration (t counts iterations):

    sample batches dP, dN (B x F each, with replacement)
    PosDist_i = ||W dP_i||^2 ,  NegDist_j = ||W dN_j||^2
    viol M_ij = PosDist_i + 1 > NegDist_j                     (B x B mask)
    dLoss = dP^T diag(rowsum M) dP - dN^T diag(colsum M) dN   (two syrk GEMMs)
    dfAvg <- (t dfAvg + dLoss / B^2) / (t + 1)
    A     <- -sqrt(t+1)/gamma (dfAvg + mu I), symmetrised
    eigendecompose A; clamp eigenvalues at 0
    A <- V diag(l+) V^T ;  W <- diag(sqrt(l+)) V^T

Every function works on a leading sweep axis S: the 45-combo grid trains
as one batch, its eigendecompositions as one batched ``torch.linalg.eigh``
on (S, F, F) and its Newton-Schulz products as batched matmuls (``vmap``
in the JAX package). The single-run functions add and drop that axis.

Modes (``eigh_mode``): "exact" (eigh every step), "subspace" (warm-started
orthogonal iteration, optional rank cap) and "psd_ns" (Newton-Schulz PSD
projection in the loop, one exact eigh at the chunk boundary). All
products are f32 with TF32 off, the JAX package's HIGHEST.

Randomness: the steps take their sampled rows as input. A chunk draws them
from a ``torch.Generator`` through ``draw_gather_rows`` (single run,
(n_steps, B) per side) or ``draw_sweep_rows`` (one independent draw per
sweep entry, (S, n_steps, B)); the tests swap these for the JAX key
schedule. Eigenvectors have no fixed sign, so W may differ from the JAX
package's by row signs; A = W^T W, ||Wx||^2 and the rank do not.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import no_tf32
from ..ops.hinge import hinge_sum_sorted
from .pr_rda import draw_gather_rows

EIGH_MODES = ("exact", "subspace", "psd_ns")


class PJState(NamedTuple):
    """Solver state; a sweep adds a leading axis S to every tensor."""

    w: torch.Tensor       # (K, F) projection, zero rows where rank deficient
    a: torch.Tensor       # (F, F) PSD metric A = W^T W (post-projection)
    df_avg: torch.Tensor  # (F, F) running subgradient average
    basis: torch.Tensor   # (F, K) eigenbasis estimate (subspace warm start)
    t: int                # iterations done (shared across the sweep)

    @classmethod
    def from_numpy(cls, fields: dict, device="cuda") -> "PJState":
        """The JAX package's PJState leaves as numpy arrays -> the port's
        state. A stacked sweep state's per-entry counters must agree."""
        t = np.asarray(fields["t"]).reshape(-1)
        if t.size > 1 and np.any(t != t[0]):
            raise ValueError(f"sweep entries at different iterations: {t}")

        def tens(name):
            return torch.from_numpy(
                np.array(fields[name], np.float32)).to(device)

        return cls(w=tens("w"), a=tens("a"), df_avg=tens("df_avg"),
                   basis=tens("basis"), t=int(t[0]) if t.size else 0)

    def to_numpy(self) -> dict:
        """The state as the JAX package's PJState leaves: float32 arrays
        and int32 counters (one per sweep entry for a stacked state)."""
        out = {k: getattr(self, k).detach().cpu().numpy()
               for k in ("w", "a", "df_avg", "basis")}
        out["t"] = np.full(self.w.shape[:-2], self.t, np.int32)
        return out


def pj_init(n_feat: int, rank_cap: Optional[int] = None,
            device="cuda") -> PJState:
    """rank_cap=K < F enables low-rank spectrum tracking (subspace mode
    only): W is (K, F) and the basis F x K."""
    k = n_feat if rank_cap is None else min(rank_cap, n_feat)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return PJState(w=z(k, n_feat), a=z(n_feat, n_feat),
                   df_avg=z(n_feat, n_feat),
                   basis=torch.eye(n_feat, k, dtype=torch.float32,
                                   device=device), t=0)


def pj_init_batch(n_feat: int, n_sweep: int, rank_cap: Optional[int] = None,
                  device="cuda") -> PJState:
    """Stacked states for a sweep: every tensor gains a leading S."""
    one = pj_init(n_feat, rank_cap, device)
    return PJState(*(x.expand((n_sweep,) + x.shape).clone()
                     for x in one[:4]), t=0)


def draw_sweep_rows(gen: torch.Generator, n_sweep: int, n_steps: int,
                    n_pos: int, n_neg: int, batch: int):
    """i.i.d. row indices with replacement, one draw per sweep entry:
    (S, n_steps, batch) per side."""
    ip = torch.randint(0, n_pos, (n_sweep, n_steps, batch), generator=gen)
    ineg = torch.randint(0, n_neg, (n_sweep, n_steps, batch), generator=gen)
    return ip, ineg


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _vec(x, device) -> torch.Tensor:
    """A float or a sequence or tensor of them as f32 on ``device``."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return _f32(x, device)


def _eye(f: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(f, dtype=torch.float32, device=like.device)


def _proj_sq_norms(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """||W x||^2 for each row x: (..., K, F) x (..., B, F) -> (..., B)."""
    p = torch.matmul(x, w.mT)
    return (p * p).sum(dim=-1)


def _metric_sq_norms(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x^T A x for each row x: identical to ||W x||^2 when A = W^T W,
    without the factor (the psd_ns loop keeps only A)."""
    return (torch.matmul(x, a) * x).sum(dim=-1)


def _psd_project(a: torch.Tensor):
    """Exact PSD projection by eigh: (W, A+, V)."""
    vals, vecs = torch.linalg.eigh(a)
    lam = torch.clamp(vals, min=0.0)
    a_psd = torch.matmul(vecs * lam[..., None, :], vecs.mT)
    w = torch.sqrt(lam)[..., :, None] * vecs.mT           # zero rows if lam == 0
    return w, a_psd, vecs


def _psd_newton_schulz(a: torch.Tensor, n_iters: int) -> torch.Tensor:
    """PSD-cone projection by the matrix sign function, matmuls only:
    A+ = (A + sign(A) A) / 2, sign(A) by the cubic Newton-Schulz iteration
    Y <- 1.5 Y - 0.5 Y^3 from Y0 = A / ||A||_F."""
    c = torch.linalg.matrix_norm(a, ord="fro") + 1e-30
    y = a / c[..., None, None]
    for _ in range(n_iters):
        y2 = torch.matmul(y, y)
        y = 1.5 * y - 0.5 * torch.matmul(y2, y)
    a_psd = 0.5 * (a + torch.matmul(y, a))
    return 0.5 * (a_psd + a_psd.mT)


def _eigh_subspace(a: torch.Tensor, basis: torch.Tensor, n_steps: int):
    """Warm-started orthogonal iteration on a + shift I, then Rayleigh-Ritz:
    (eigenvalues, eigenvectors) of the tracked subspace."""
    shift = torch.linalg.matrix_norm(a, ord="fro") + 1e-6
    a_sh = a + shift[..., None, None] * _eye(a.shape[-1], a)
    v = basis
    for _ in range(n_steps):
        v, _ = torch.linalg.qr(torch.matmul(a_sh, v))
    t_small = torch.matmul(v.mT, torch.matmul(a, v))
    t_small = 0.5 * (t_small + t_small.mT)
    vals, s = torch.linalg.eigh(t_small)
    return vals, torch.matmul(v, s)


def _pj_step(pos_trn, neg_trn, mu, gamma, batch: int, state: PJState,
             ip: torch.Tensor, ineg: torch.Tensor, eigh_mode: str,
             subspace_steps: int, ns_iters: int) -> PJState:
    """One RDA iteration of every sweep entry on its sampled rows
    ip, ineg (S, B)."""
    dp = pos_trn[ip].to(torch.float32)                     # (S, B, F)
    dn = neg_trn[ineg].to(torch.float32)
    psd = eigh_mode == "psd_ns"
    if psd:
        pos_dist = _metric_sq_norms(state.a, dp)           # (S, B)
        neg_dist = _metric_sq_norms(state.a, dn)
    else:
        pos_dist = _proj_sq_norms(state.w, dp)
        neg_dist = _proj_sq_norms(state.w, dn)
    viol = (pos_dist[..., :, None] + 1.0
            > neg_dist[..., None, :]).to(torch.float32)    # (S, B, B)
    n_viol = viol.sum(dim=-1)                              # per positive
    cnt = viol.sum(dim=-2)                                 # per negative
    dloss = (torch.matmul(dp.mT * n_viol[..., None, :], dp)
             - torch.matmul(dn.mT * cnt[..., None, :], dn))

    tf = _f32(state.t, dp.device)
    df_avg = (tf * state.df_avg
              + dloss / _f32(batch * batch, dp.device)) / (tf + 1.0)
    a = -(torch.sqrt(tf + 1.0) / gamma)[..., None, None] * (
        df_avg + mu[..., None, None] * _eye(dp.shape[-1], dp))
    a = 0.5 * (a + a.mT)

    if psd:
        # factor-free projection: w and basis ride stale through the chunk
        return PJState(w=state.w, a=_psd_newton_schulz(a, ns_iters),
                       df_avg=df_avg, basis=state.basis, t=state.t + 1)
    if eigh_mode == "subspace":
        vals, vecs = _eigh_subspace(a, state.basis, subspace_steps)
        lam = torch.clamp(vals, min=0.0)
        a_psd = torch.matmul(vecs * lam[..., None, :], vecs.mT)
        w = torch.sqrt(lam)[..., :, None] * vecs.mT
    else:
        w, a_psd, vecs = _psd_project(a)
    return PJState(w=w, a=a_psd, df_avg=df_avg, basis=vecs, t=state.t + 1)


def _check_mode(eigh_mode: str, state: PJState) -> None:
    if eigh_mode not in EIGH_MODES:
        raise ValueError(f"unknown eigh_mode: {eigh_mode}")
    if eigh_mode != "subspace" and state.basis.shape[-1] != \
            state.basis.shape[-2]:
        raise ValueError(
            "rank_cap (truncated basis) requires eigh_mode='subspace'")


def _run_chunk(pos_trn, neg_trn, mus, gammas, states: PJState, ip, ineg, *,
               batch: int, eigh_mode: str, subspace_steps: int,
               ns_iters: int) -> PJState:
    """n_steps iterations of S stacked states on rows ip, ineg
    (S, n_steps, B)."""
    no_tf32()
    _check_mode(eigh_mode, states)
    dev = states.a.device
    ip, ineg = ip.to(dev), ineg.to(dev)
    for k in range(ip.shape[1]):
        states = _pj_step(pos_trn, neg_trn, mus, gammas, batch, states,
                          ip[:, k], ineg[:, k], eigh_mode, subspace_steps,
                          ns_iters)
    if eigh_mode == "psd_ns":
        # chunk-boundary factorisation: rebuild the exact iterate from
        # df_avg; the last step used tf = t - 1, so sqrt(tf + 1) = sqrt(t)
        tf = _f32(states.t, dev)
        a_pre = -(torch.sqrt(tf) / gammas)[..., None, None] * (
            states.df_avg + mus[..., None, None] * _eye(
                states.a.shape[-1], states.a))
        w, a_psd, vecs = _psd_project(0.5 * (a_pre + a_pre.mT))
        states = PJState(w=w, a=a_psd, df_avg=states.df_avg, basis=vecs,
                         t=states.t)
    return states


def pj_train_chunk(pos_trn, neg_trn, mu, gamma, state: PJState,
                   gen: torch.Generator, *, batch: int, n_steps: int,
                   eigh_mode: str = "exact", subspace_steps: int = 4,
                   ns_iters: int = 24) -> PJState:
    """Run n_steps PJ RDA iterations of one (mu, gamma) run.

    eigh_mode "exact": eigh every step (reference semantics,
    src/pj-learn.cpp:440-446); "subspace": warm-started orthogonal
    iteration (+ rank_cap); "psd_ns": Newton-Schulz PSD projection inside
    the loop and one exact eigh at the chunk boundary, so the state any
    consumer sees is a true eigendecomposition.
    """
    dev = state.a.device
    ip, ineg = draw_gather_rows(gen, n_steps, pos_trn.shape[0],
                                neg_trn.shape[0], batch)
    one = PJState(*(x[None] for x in state[:4]), t=state.t)
    out = _run_chunk(pos_trn, neg_trn, _vec(mu, dev).reshape(1),
                     _vec(gamma, dev).reshape(1),
                     one, ip[None], ineg[None], batch=batch,
                     eigh_mode=eigh_mode, subspace_steps=subspace_steps,
                     ns_iters=ns_iters)
    return PJState(*(x[0] for x in out[:4]), t=out.t)


def pj_train_chunk_batch(pos_trn, neg_trn, mus, gammas, states: PJState,
                         gen: torch.Generator, *, batch: int, n_steps: int,
                         eigh_mode: str = "exact", subspace_steps: int = 4,
                         ns_iters: int = 24) -> PJState:
    """A sweep's chunk: S stacked states share the dataset, each with its
    own sampled rows; the S eigendecompositions run as one batched eigh."""
    s = states.a.shape[0]
    ip, ineg = draw_sweep_rows(gen, s, n_steps, pos_trn.shape[0],
                               neg_trn.shape[0], batch)
    dev = states.a.device
    return _run_chunk(pos_trn, neg_trn, _vec(mus, dev), _vec(gammas, dev),
                      states, ip, ineg, batch=batch, eigh_mode=eigh_mode,
                      subspace_steps=subspace_steps, ns_iters=ns_iters)


def pj_validate(pos_val, neg_val, mu, state: PJState):
    """Validation objective (reference: src/pj-learn.cpp:501-527).

    Loss = all-pairs hinge of projected squared distances / (|P||N|);
    Regul = mu * trace(A). Returns (loss_val, regul, obj, rank), each
    0-d, or (S,) for a stacked state with mu (S,)."""
    no_tf32()
    dev = state.a.device
    pd = _proj_sq_norms(state.w, pos_val.to(torch.float32))
    nd = _proj_sq_norms(state.w, neg_val.to(torch.float32))
    loss = hinge_sum_sorted(pd, nd)
    loss_val = loss / (_f32(pos_val.shape[0], dev)
                       * _f32(neg_val.shape[0], dev))
    regul = _vec(mu, dev) * torch.diagonal(state.a, dim1=-2, dim2=-1).sum(dim=-1)
    rank = (state.w != 0.0).any(dim=-1).sum(dim=-1)
    return loss_val, regul, loss_val + regul, rank


def pj_train(pos_trn, neg_trn, pos_val, neg_val, cfg, *, gen=None,
             on_log=None):
    """Host loop of one (mu, gamma) PJ run; returns (w_best, history).
    ``on_log(rec, state)`` receives every validation record. The full-stat
    dual best criterion lives in Workspace.pjlearn."""
    if gen is None:
        gen = torch.Generator().manual_seed(cfg.seed)
    state = pj_init(pos_trn.shape[1], cfg.rank_cap, device=pos_trn.device)
    n_logs = max(1, cfg.n_iter // cfg.log_step)
    obj_best = np.inf
    w_best = np.zeros(tuple(state.w.shape), np.float32)
    history = []
    for _ in range(n_logs):
        state = pj_train_chunk(pos_trn, neg_trn, cfg.mu, cfg.gamma, state,
                               gen, batch=cfg.batch, n_steps=cfg.log_step,
                               eigh_mode=cfg.eigh_mode,
                               subspace_steps=cfg.subspace_steps,
                               ns_iters=cfg.ns_iters)
        loss_val, regul, obj, rank = pj_validate(pos_val, neg_val, cfg.mu,
                                                 state)
        obj0 = float(obj)
        rec = {"t": state.t, "loss": float(loss_val), "regul": float(regul),
               "obj": obj0, "rank": int(rank), "best": obj0 < obj_best}
        if obj0 < obj_best:
            obj_best = obj0
            w_best = state.w.cpu().numpy()
        rec["obj_best"] = obj_best
        history.append(rec)
        if on_log is not None:
            on_log(rec, state)
    return w_best, history
