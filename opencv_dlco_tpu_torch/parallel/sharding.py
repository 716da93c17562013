"""Sharded compute paths: each rank runs on its shard, collectives join them.

Port of ``opencv_dlco_tpu/parallel/sharding.py`` in torch's SPMD idiom:
every rank calls a function with its OWN shard (a local tensor) and the
mesh (parallel/mesh.py); the mesh's per-axis process groups carry the
collectives. The JAX package takes global arrays laid out by a
NamedSharding instead; the names are its names.

Layout: the (pairs, rings) matrices are P(dp, mp) — pair rows over ``dp``,
ring/feature columns over ``mp``. The solvers keep their iterates sharded
over ``mp`` and replicated over ``dp``; each step does

    f   = psum_mp(local_partial_dots)     (contraction over sharded features)
    g   = psum_dp(local_subgradients)     (reduction over sharded samples)

which is the single-device RDA recursion (batch per step = per-rank batch
x dp). ``psum`` is an all_reduce SUM, JAX's all_gather(tiled=True) an
all_gather followed by cat. The distance precompute needs no collective.

Randomness comes in as input, as everywhere in the port: the sharded PR
and PJ steps take each step's row indices of this rank's shard
(``draw_dp_rows`` draws them from one generator every rank holds in the
same state, a slice per dp rank); the sweeps draw exactly what the
single-device sweep draws.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import no_tf32
from ..models import pj_rda, pr_rda
from ..models.pj_rda import PJState, _psd_project
from ..models.pr_rda import PRState, pr_train_chunk
from ..ops.hinge import hinge_sum_sorted
from ..ops.pair_distance import ring_distances
from ..ops.roc import roc_stats
from .mesh import Mesh, data_axis, model_axis


class Sharding(NamedTuple):
    """Which mesh axis splits each leading dimension of an array (None:
    replicated); trailing dimensions beyond ``spec`` are replicated."""

    mesh: Mesh
    spec: tuple

    def block(self, shape) -> tuple:
        """This rank's slices of an array of ``shape``."""
        out = []
        for i, n in enumerate(shape):
            axis = self.spec[i] if i < len(self.spec) else None
            if axis is None:
                out.append(slice(None))
                continue
            parts = self.mesh.shape[axis]
            if n % parts:
                raise ValueError(f"dimension {i} of {tuple(shape)} not "
                                 f"divisible by {axis}={parts}")
            k = self.mesh.axis_index(axis)
            out.append(slice(k * (n // parts), (k + 1) * (n // parts)))
        return tuple(out)

    def shard(self, arr) -> torch.Tensor:
        """This rank's block of a global array (numpy or tensor), as a
        tensor on the mesh's device."""
        if not torch.is_tensor(arr):
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        return arr[self.block(arr.shape)].contiguous().to(self.mesh.device)


def distance_sharding(mesh: Mesh) -> Sharding:
    """Rows (pairs) over dp, columns (rings/features) over mp."""
    return Sharding(mesh, (data_axis, model_axis))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_distance_matrix(arr, mesh: Mesh) -> torch.Tensor:
    """This rank's (rows / dp, cols / mp) block of a (pairs, rings) matrix."""
    return distance_sharding(mesh).shard(arr)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product, TF32 off (JAX's Precision.HIGHEST)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def draw_dp_rows(gen: torch.Generator, mesh: Mesh, n_steps: int,
                 n_pos: int, n_neg: int, batch_per_device: int):
    """Row indices into this rank's (n_pos, n_neg)-row shards, (n_steps,
    batch_per_device) per side: one draw of dp x batch_per_device rows a
    step from ``gen`` (the same state on every rank), this dp rank's slice
    of it — an independent stream per dp rank, like the JAX package's
    fold_in(key, dp_index)."""
    n_dp = mesh.shape[data_axis]
    ip, ineg = pr_rda.draw_gather_rows(gen, n_steps, n_pos, n_neg,
                                       batch_per_device * n_dp)
    cols = slice(mesh.axis_index(data_axis) * batch_per_device,
                 (mesh.axis_index(data_axis) + 1) * batch_per_device)
    return ip[:, cols], ineg[:, cols]


def _check_rows(rows, n_steps: int, batch_per_device: int):
    ip, ineg = rows
    if tuple(ip.shape) != (n_steps, batch_per_device) or \
            tuple(ineg.shape) != (n_steps, batch_per_device):
        raise ValueError(f"row draws {tuple(ip.shape)}, {tuple(ineg.shape)}"
                         f" != ({n_steps}, {batch_per_device})")


# -- stage 3: distance precompute ---------------------------------------

def ring_distances_sharded(mesh: Mesh, filters, pt1, pt2,
                           n_symmetries: int = 8) -> torch.Tensor:
    """ring_distances on this rank's block: ``filters`` are its rows of the
    bank (mp shard), ``pt1``/``pt2`` its pairs (dp shard); returns its
    (pairs / dp, rings / mp) block of the distance matrix. No collective:
    the ring reduction stays within an mp shard because shards are whole
    rings (checked)."""
    if filters.shape[0] % n_symmetries:
        raise ValueError(f"filter shard of {filters.shape[0]} rows is not "
                         f"whole rings of {n_symmetries}; the ring count "
                         f"must divide by mp={mesh.shape[model_axis]}")
    return ring_distances(filters, pt1, pt2, n_symmetries)


# -- stage 5: model-selection stats pass ---------------------------------

def pr_stats_sharded(mesh: Mesh, dists, labels, w_rows):
    """Cross-dataset stats (FPR95/AUC per model row) over the sharded
    distance matrix (src/pr-stats.cpp:196-252): the (N, F) x (F, R)
    scoring product runs on each block with one psum over mp, then the
    per-pair scores and labels are all-gathered over dp and every rank
    runs the same batched ROC sweep.

    dists: this rank's (N / dp, F / mp) block; labels: its (N / dp,);
    w_rows: (R, F / mp). Returns (fpr95 (R,), auc (R,)), the same on every
    rank."""
    pd = mesh.psum(_dot(dists, w_rows.T), model_axis)        # (N/dp, R)
    pd_full = mesh.all_gather(pd, data_axis)
    lab_full = mesh.all_gather(labels.to(torch.float32), data_axis)
    return roc_stats(pd_full.T, lab_full)


# -- stage 4: PR RDA -------------------------------------------------------

def pr_train_chunk_sharded(mesh: Mesh, pos_trn, neg_trn, mu, gamma,
                           state: PRState, rows, *, batch_per_device: int,
                           n_steps: int) -> PRState:
    """Sharded equivalent of pr_train_chunk (gather sampling).

    pos_trn/neg_trn are this rank's (dp, mp) blocks, state.w/df_avg its
    (S, F / mp) columns; ``rows`` = (ip, ineg), (n_steps,
    batch_per_device) indices into its row shards. The RDA batch per step
    is batch_per_device x dp."""
    _check_rows(rows, n_steps, batch_per_device)
    dev = state.w.device
    ip, ineg = (r.to(dev) for r in rows)
    n_dp = mesh.shape[data_axis]
    w, df, t = state.w, state.df_avg, state.t
    for k in range(n_steps):
        fd = pos_trn[ip[k]].to(torch.float32) \
            - neg_trn[ineg[k]].to(torch.float32)            # (B, F/mp)
        f = mesh.psum(_dot(fd, w.T), model_axis)             # (B, S)
        viol = (f > -1.0).to(torch.float32)
        g = mesh.psum(_dot(viol.T, fd), data_axis)           # (S, F/mp)
        t_new = t + batch_per_device * n_dp
        tf = torch.tensor(np.float32(t), device=dev)
        tnf = torch.tensor(np.float32(t_new), device=dev)
        df = (tf * df + g) / tnf
        w = torch.clamp(
            -torch.sqrt(tnf) / gamma[:, None] * (df + mu[:, None]), min=0.0)
        t = t_new
    return PRState(w=w, df_avg=df, t=t)


def pr_validate_sharded(mesh: Mesh, pos_val, neg_val, mu, state: PRState):
    """Sharded validation: the all-pairs hinge (sorted form) with the
    negatives' scores all-gathered over dp and the positives kept local.
    pos_val/neg_val: this rank's (dp, mp) blocks (every dp shard the same
    size). Returns (loss_val, regul, obj, nnz), each (S,), the same on
    every rank."""
    w = state.w
    pd = mesh.psum(_dot(pos_val, w.T), model_axis)           # (Np/dp, S)
    nd = mesh.psum(_dot(neg_val, w.T), model_axis)
    nd_full = mesh.all_gather(nd, data_axis)                 # (Nn, S)
    loss = mesh.psum(hinge_sum_sorted(pd.T, nd_full.T), data_axis)
    regul = mu * mesh.psum(w.abs().sum(dim=1), model_axis)
    nnz = mesh.psum((w > 0.0).sum(dim=1), model_axis)
    n_dp = mesh.shape[data_axis]
    denom = (torch.tensor(np.float32(pos_val.shape[0] * n_dp))
             * torch.tensor(np.float32(neg_val.shape[0] * n_dp))
             ).to(loss.device)
    loss_val = loss / denom
    return loss_val, regul, loss_val + regul, nnz


# -- stage 8: PJ RDA -------------------------------------------------------

def pj_train_chunk_sharded(mesh: Mesh, pos_trn, neg_trn, mu, gamma,
                           state: PJState, rows, *, batch_per_device: int,
                           n_steps: int) -> PJState:
    """Sharded PJ step (exact eigh): batch rows over dp (features
    replicated — F is a few hundred), the projected distances exchanged by
    one all_gather a step, dLoss psum-reduced over dp, and the same
    eigendecomposition on every rank.

    pos_trn/neg_trn: this rank's dp row shards; ``rows`` = (ip, ineg),
    (n_steps, batch_per_device) indices into them."""
    no_tf32()
    _check_rows(rows, n_steps, batch_per_device)
    dev = state.a.device
    ip, ineg = (r.to(dev) for r in rows)
    batch = batch_per_device * mesh.shape[data_axis]
    mu = torch.as_tensor(mu, dtype=torch.float32, device=dev)
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=dev)
    eye = torch.eye(pos_trn.shape[1], dtype=torch.float32, device=dev)
    for k in range(n_steps):
        dp_b = pos_trn[ip[k]].to(torch.float32)
        dn_b = neg_trn[ineg[k]].to(torch.float32)
        pd = (_dot(dp_b, state.w.T) ** 2).sum(1)
        nd = (_dot(dn_b, state.w.T) ** 2).sum(1)
        pd_full, nd_full = mesh.all_gather(torch.stack([pd, nd]), data_axis,
                                           dim=1)
        # per-local-positive violations vs ALL negatives, and
        # per-local-negative violations vs ALL positives
        n_viol = (pd[:, None] + 1.0 > nd_full[None, :]).to(
            torch.float32).sum(1)
        cnt = (pd_full[:, None] + 1.0 > nd[None, :]).to(torch.float32).sum(0)
        dloss = (_dot(dp_b.T * n_viol[None, :], dp_b)
                 - _dot(dn_b.T * cnt[None, :], dn_b))
        dloss = mesh.psum(dloss, data_axis)
        tf = torch.tensor(np.float32(state.t), device=dev)
        df = (tf * state.df_avg + dloss / torch.tensor(
            np.float32(batch * batch), device=dev)) / (tf + 1.0)
        a_new = -(torch.sqrt(tf + 1.0) / gamma) * (df + mu * eye)
        w, a_psd, vecs = _psd_project(0.5 * (a_new + a_new.T))
        state = PJState(w=w, a=a_psd, df_avg=df, basis=vecs, t=state.t + 1)
    return state


# -- sweeps: the hyperparameter axis S over dp -----------------------------

def _sweep_block(mesh: Mesh, s: int) -> slice:
    n_dp = mesh.shape[data_axis]
    if s % n_dp:
        raise ValueError(f"sweep width {s} not divisible by dp={n_dp}; "
                         f"pad the grid")
    per = s // n_dp
    k = mesh.axis_index(data_axis)
    return slice(k * per, (k + 1) * per)


def shard_sweep(mesh: Mesh, mus, gammas, state: PRState):
    """This dp rank's S / dp combos of a PR sweep: (mus, gammas, state).
    The data stays replicated: the sweep needs no collective until its
    result is gathered. S must divide by dp (pad the grid otherwise)."""
    blk = _sweep_block(mesh, state.w.shape[0])
    return (mus[blk], gammas[blk],
            PRState(w=state.w[blk], df_avg=state.df_avg[blk], t=state.t))


def pr_sweep_chunk_sharded(mesh: Mesh, pos_trn, neg_trn, mus, gammas,
                           state: PRState, gen: torch.Generator, *,
                           batch: int, n_steps: int,
                           sampling: str = "gather",
                           precision: str = "highest") -> PRState:
    """pr_train_chunk with the sweep axis over dp: every rank runs the
    single-device chunk on its S / dp combos with the same draws (``gen``
    in the same state on every rank: the combos share each step's
    sample), then the states are all-gathered over dp. Data, mus, gammas
    and the state come in whole (replicated) and the result goes out
    whole. Kernel B runs where S / dp > 8, kernel C at S / dp <= 8."""
    mus_l, gammas_l, st_l = shard_sweep(mesh, mus, gammas, state)
    out = pr_train_chunk(pos_trn, neg_trn, mus_l, gammas_l, st_l, gen,
                         batch=batch, n_steps=n_steps, sampling=sampling,
                         precision=precision)
    return PRState(w=mesh.all_gather(out.w, data_axis),
                   df_avg=mesh.all_gather(out.df_avg, data_axis), t=out.t)


def shard_pj_sweep(mesh: Mesh, mus, gammas, states: PJState):
    """This dp rank's S / dp combos of a PJ sweep: every stacked field,
    the (S, F, F) metric and subgradient tensors whose batched eigh is the
    PJ bottleneck included, splits over dp."""
    blk = _sweep_block(mesh, states.a.shape[0])
    return (mus[blk], gammas[blk],
            PJState(*(x[blk] for x in states[:4]), t=states.t))


def pj_sweep_chunk_sharded(mesh: Mesh, pos_trn, neg_trn, mus, gammas,
                           states: PJState, gen: torch.Generator, *,
                           batch: int, n_steps: int,
                           eigh_mode: str = "exact",
                           subspace_steps: int = 4,
                           ns_iters: int = 24) -> PJState:
    """pj_train_chunk_batch with the sweep axis over dp: the rows of all
    S combos are drawn as the single-device sweep draws them, each rank
    trains its S / dp combos on theirs (S / dp of the eigh batch), and the
    states are all-gathered over dp."""
    s = states.a.shape[0]
    mus_l, gammas_l, st_l = shard_pj_sweep(mesh, mus, gammas, states)
    ip, ineg = pj_rda.draw_sweep_rows(gen, s, n_steps, pos_trn.shape[0],
                                      neg_trn.shape[0], batch)
    blk = _sweep_block(mesh, s)
    dev = states.a.device
    out = pj_rda._run_chunk(
        pos_trn, neg_trn, pj_rda._vec(mus_l, dev), pj_rda._vec(gammas_l, dev),
        st_l, ip[blk], ineg[blk], batch=batch, eigh_mode=eigh_mode,
        subspace_steps=subspace_steps, ns_iters=ns_iters)
    return PJState(*(mesh.all_gather(x, data_axis) for x in out[:4]),
                   t=out.t)
