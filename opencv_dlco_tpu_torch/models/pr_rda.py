"""Pooling-region learner: L1-regularised hinge-loss RDA, batched.

Port of ``opencv_dlco_tpu/models/pr_rda.py`` (reference:
src/pr-learn.cpp:302-434). Each optimizer step consumes a batch of B
sampled (pos, neg) pairs:

    FeatDiff_b = D[pos_b] - D[neg_b]                 (B x F)
    f_b        = FeatDiff_b . w
    g          = sum_{b : f_b > -1} FeatDiff_b
    dfAvg     <- (t * dfAvg + g) / (t + B)           (t counts samples)
    w         <- max(0, -sqrt(t + B) / gamma * (dfAvg + mu))

Everything carries a leading sweep axis S: a (mu, gamma) grid trains as
one loop whose per-sample work is (B,F)x(F,S) products shared by the grid.

Randomness: a ``torch.Generator`` feeds the two draw functions, one call
per chunk — ``ops.fused_rda.draw_block_offsets`` for the block modes and
``draw_gather_rows`` for the gather mode. The JAX package draws the same
distributions from a PRNG key; the tests swap these functions for the JAX
key schedule to compare runs sample for sample.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.fused_rda import (
    draw_block_offsets,
    fused_block_train,
    fused_block_train_wide,
)
from ..ops.hinge import hinge_sum_sorted

TILE_B = 128  # block-offset granularity of the fused path (rows)


class PRState(NamedTuple):
    """Solver state; leading axis S = sweep entries."""

    w: torch.Tensor       # (S, F) current iterate (non-negative), f32
    df_avg: torch.Tensor  # (S, F) running subgradient average, f32
    t: int                # samples processed (shared across the sweep)


def pr_init(n_feat: int, n_sweep: int = 1, device="cuda") -> PRState:
    z = torch.zeros((n_sweep, n_feat), dtype=torch.float32, device=device)
    return PRState(w=z, df_avg=z.clone(), t=0)


def pr_state_from_numpy(w, df_avg, t, device="cuda") -> PRState:
    """Carry a solver state held as numpy (e.g. the JAX package's w,
    df_avg, t) into the port."""
    return PRState(
        w=torch.from_numpy(np.array(w, np.float32)).to(device),
        df_avg=torch.from_numpy(np.array(df_avg, np.float32)).to(device),
        t=int(np.asarray(t)))


def pr_state_to_numpy(state: PRState):
    """(w, df_avg, t) as float32 arrays and an int32 scalar, the JAX
    package's PRState leaves."""
    return (state.w.detach().cpu().numpy(),
            state.df_avg.detach().cpu().numpy(), np.int32(state.t))


def draw_gather_rows(gen: torch.Generator, n_steps: int, n_pos: int,
                     n_neg: int, batch: int):
    """i.i.d. row indices with replacement: (n_steps, batch) per side."""
    ip = torch.randint(0, n_pos, (n_steps, batch), generator=gen)
    ineg = torch.randint(0, n_neg, (n_steps, batch), generator=gen)
    return ip, ineg


def _matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """f32 product; "default" rounds both operands to bf16 first (the
    precision class of the TPU's DEFAULT matmul), accumulation stays f32."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if precision != "highest":
        a = a.to(torch.bfloat16).to(torch.float32)
        b = b.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(a, b)


def _diff(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """FeatDiff of the unfused steps, in f32 whatever the split dtype: XLA
    keeps this difference at f32 inside the fused step program (excess
    precision), unlike the fused kernels, which round fd to the input dtype."""
    return pos.to(torch.float32) - neg.to(torch.float32)


def _pr_step(fd: torch.Tensor, mu, gamma, batch: int, state: PRState,
             precision: str) -> PRState:
    """One batched RDA step on the sampled FeatDiff rows fd (B, F)."""
    f = _matmul(fd, state.w.T, precision)                    # (B, S)
    viol = (f > -1.0).to(torch.float32)
    g = _matmul(viol.T, fd, precision)                       # (S, F)
    t_new = state.t + batch
    tf = torch.tensor(np.float32(state.t), device=fd.device)
    tnf = torch.tensor(np.float32(t_new), device=fd.device)
    df_avg = (tf * state.df_avg + g) / tnf
    w = torch.clamp(-torch.sqrt(tnf) / gamma[:, None] * (df_avg + mu[:, None]),
                    min=0.0)
    return PRState(w=w, df_avg=df_avg, t=t_new)


def pr_train_chunk(pos_trn: torch.Tensor, neg_trn: torch.Tensor,
                   mu: torch.Tensor, gamma: torch.Tensor, state: PRState,
                   gen: torch.Generator, *, batch: int, n_steps: int,
                   sampling: str = "gather",
                   precision: str = "highest") -> PRState:
    """Run n_steps batched RDA steps (n_steps * batch reference iterations).

    sampling="gather": i.i.d. rows with replacement (reference semantics);
    "block": a random contiguous block of the pre-shuffled rows per side;
    "block_fused": block mode through the fused kernels, taken when
    batch % 128 == 0 and batch < min(n_pos, n_neg) (the JAX rule) — S <= 8
    goes to kernel C, wider grids to kernel B. The TPU's VMEM-fit rule does
    not apply: kernel B keeps the state in device memory and L2, so shapes
    it cannot take raise instead of rerouting. Otherwise the steps run as
    a loop here, with block mode falling back to gather when a side has no
    full block.
    """
    s_axis = state.w.shape[0]
    n_pos, n_neg = pos_trn.shape[0], neg_trn.shape[0]
    has_block = batch < min(n_pos, n_neg)
    if sampling == "block_fused" and batch % TILE_B == 0 and has_block:
        offs = draw_block_offsets(gen, n_steps, n_pos, n_neg, batch, TILE_B)
        kernel = fused_block_train if s_axis <= 8 else fused_block_train_wide
        w, df_avg, t = kernel(pos_trn, neg_trn, state.w, state.df_avg,
                              state.t, mu, gamma, offs, batch=batch,
                              tile_b=TILE_B)
        return PRState(w=w, df_avg=df_avg, t=t)

    if sampling in ("block", "block_fused") and has_block:
        offs = draw_block_offsets(gen, n_steps, n_pos, n_neg, batch, 1)
        for ip0, in0 in offs.tolist():
            fd = _diff(pos_trn[ip0:ip0 + batch], neg_trn[in0:in0 + batch])
            state = _pr_step(fd, mu, gamma, batch, state, precision)
        return state
    ip, ineg = draw_gather_rows(gen, n_steps, n_pos, n_neg, batch)
    ip, ineg = ip.to(pos_trn.device), ineg.to(neg_trn.device)
    for k in range(n_steps):
        fd = _diff(pos_trn[ip[k]], neg_trn[ineg[k]])
        state = _pr_step(fd, mu, gamma, batch, state, precision)
    return state


def pr_validate(pos_val: torch.Tensor, neg_val: torch.Tensor,
                mu: torch.Tensor, state: PRState):
    """Validation objective per sweep entry (reference:
    src/pr-learn.cpp:340-365): all-pairs hinge on the held-out split via
    the sorted kernel, normalised by |P||N|, plus the L1 regulariser.

    Returns (loss_val, regul, obj, nnz), each (S,)."""
    pd = torch.matmul(pos_val, state.w.T)                    # (Np, S)
    nd = torch.matmul(neg_val, state.w.T)                    # (Nn, S)
    loss = hinge_sum_sorted(pd.T, nd.T)                      # (S,)
    denom = (torch.tensor(np.float32(pos_val.shape[0]))
             * torch.tensor(np.float32(neg_val.shape[0]))).to(loss.device)
    loss_val = loss / denom
    regul = mu * state.w.abs().sum(dim=1)
    nnz = (state.w > 0.0).sum(dim=1)
    return loss_val, regul, loss_val + regul, nnz


def pr_train(pos_trn, neg_trn, pos_val, neg_val, cfg, *, gen=None,
             on_log=None):
    """Host driver for a single (mu, gamma) run; returns (best_w, history).

    ``on_log(rec, state)`` fires every cfg.log_step samples. Sweeps use
    parallel/sweep.py instead."""
    if gen is None:
        gen = torch.Generator().manual_seed(cfg.seed)
    dev = pos_trn.device
    n_feat = pos_trn.shape[1]
    state = pr_init(n_feat, 1, device=dev)
    mu = torch.tensor([cfg.mu], dtype=torch.float32, device=dev)
    gamma = torch.tensor([cfg.gamma], dtype=torch.float32, device=dev)

    steps_per_log = max(1, cfg.log_step // cfg.batch)
    n_logs = max(1, cfg.n_iter // (steps_per_log * cfg.batch))

    obj_best = np.inf
    w_best = np.zeros((n_feat,), np.float32)
    history = []
    for _ in range(n_logs):
        state = pr_train_chunk(pos_trn, neg_trn, mu, gamma, state, gen,
                               batch=cfg.batch, n_steps=steps_per_log)
        loss_val, regul, obj, nnz = pr_validate(pos_val, neg_val, mu, state)
        obj0 = float(obj[0])
        rec = {"t": int(state.t), "loss": float(loss_val[0]),
               "regul": float(regul[0]), "obj": obj0, "nnz": int(nnz[0]),
               "best": obj0 < obj_best}
        if obj0 < obj_best:
            obj_best = obj0
            w_best = state.w[0].cpu().numpy()
        rec["obj_best"] = obj_best
        history.append(rec)
        if on_log is not None:
            on_log(rec, state)
    return w_best, history
