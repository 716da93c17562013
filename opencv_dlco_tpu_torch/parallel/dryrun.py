"""Multi-device dry run: every sharded path once, on tiny shapes.

The port's counterpart of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py``), called on EVERY rank of an initialised process
group (or alone, as a (1, 1) mesh without one). In order: the sharded PR
chunk and validation; stage 3 sharded (pairs over dp, filter rows over mp),
written to the multi-writer store by the dp ranks and read back; PR on the
stored stage 3; the sharded stats pass; the sharded PJ chunk; the
edge-sharded Sim(3) pose graph; the landmark-sharded multi-view BA. The
mesh follows the JAX rule: mp = 2 when the rank count is even.

The store lies under the temporary directory of rank 0's choosing: ranks
on several hosts need it on a filesystem they share.

    python -m opencv_dlco_tpu_torch.parallel.dryrun [--device cpu]

runs it (with the DLCO_* variables of parallel/distributed.py on every
process for several ranks).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .distributed import distributed_init, host_info, is_initialized
from .mesh import data_axis, make_mesh, model_axis


def _barrier() -> None:
    if is_initialized():
        dist.barrier()


def _shared_token(device) -> int:
    """A random number of rank 0's, the same on every rank."""
    tok = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64).to(device)
    if is_initialized():
        dist.broadcast(tok, src=0)
    return int(tok.item())


def dryrun_multichip(device="cuda") -> dict:
    """Run every sharded path once on this rank; returns the summary the
    one-line report prints (the same on every rank)."""
    from ..data.shard_store import ShardedArrayStore
    from ..data.synthetic import synth_patch_pairs
    from ..geometry.mvba import multi_view_ba_sharded, shard_ba_problem
    from ..geometry.posegraph import optimize_pose_graph_sim3_sharded
    from ..geometry.se3 import so3_exp
    from ..models.pj_rda import pj_init
    from ..models.pr_rda import pr_init
    from ..ops.patch_transform import batch_patch_transform
    from ..ops.pool_regions import build_filter_bank
    from ..utils.configs import PoolRegionConfig
    from .sharding import (Sharding, draw_dp_rows, pj_train_chunk_sharded,
                           pr_stats_sharded, pr_train_chunk_sharded,
                           pr_validate_sharded, ring_distances_sharded,
                           shard_distance_matrix)

    distributed_init(device=device)
    info = host_info(device)
    n_ranks = info["process_count"]
    mp = 2 if n_ranks % 2 == 0 else 1
    # ranks ordered by (host, local index): mp inside a host, dp across
    mesh = make_mesh(dp=n_ranks // mp, mp=mp, device=device)
    dp = mesh.shape[data_axis]
    dev = mesh.device
    gen = torch.Generator().manual_seed(0)

    # PR: data P(dp, mp), iterate P(None, mp), psum over both axes
    n_rows, n_feat = 8 * n_ranks, 256
    pos = torch.randn((n_rows, n_feat), generator=gen).abs()
    neg = torch.randn((n_rows, n_feat), generator=gen).abs() + 0.5
    pos_s = shard_distance_matrix(pos, mesh)
    neg_s = shard_distance_matrix(neg, mesh)
    mu = torch.tensor([0.025], device=dev)
    gamma = torch.tensor([0.1], device=dev)
    rows = draw_dp_rows(gen, mesh, 1, pos_s.shape[0], neg_s.shape[0], 4)
    st = pr_train_chunk_sharded(mesh, pos_s, neg_s, mu, gamma,
                                pr_init(pos_s.shape[1], 1, device=dev), rows,
                                batch_per_device=4, n_steps=1)
    loss, regul, obj, nnz = pr_validate_sharded(mesh, pos_s, neg_s, mu, st)
    assert st.t == 4 * dp, st.t

    # stage 3: ring distances with pairs over dp and filter rows over mp
    # (no collective), landed in the multi-writer store, read back
    n_pairs = 8 * n_ranks
    _, _, bank = build_filter_bank(PoolRegionConfig(nr=6, nphi=2, nsigma=3))
    n_rings3 = bank.shape[0] // 8        # 36: divisible by mp
    p1, p2, labels3 = synth_patch_pairs(np.random.default_rng(3),
                                        n_pairs=n_pairs, pos_frac=0.5)
    rows_dp = Sharding(mesh, (data_axis,))
    pt1 = batch_patch_transform(rows_dp.shard(p1))
    pt2 = batch_patch_transform(rows_dp.shard(p2))
    f_sh = Sharding(mesh, (model_axis,)).shard(bank)
    d3_blk = ring_distances_sharded(mesh, f_sh, pt1, pt2)
    d3_rows = mesh.all_gather(d3_blk, model_axis, dim=1).cpu().numpy()
    assert d3_rows.shape == (n_pairs // dp, n_rings3), d3_rows.shape

    root = os.path.join(tempfile.gettempdir(),
                        f"dlco-dryrun-stage3-{_shared_token(dev):x}")
    try:
        st3 = ShardedArrayStore(root)
        st3.create("Distance", (n_pairs, n_rings3), np.float32,
                   n_pairs // dp)
        dp_idx = mesh.axis_index(data_axis)
        if mesh.axis_index(model_axis) == 0:      # one writer per dp shard
            st3.write_rows("Distance", dp_idx * (n_pairs // dp), d3_rows)
            st3.mark_done(dp_idx, {"rows": [dp_idx * (n_pairs // dp),
                                            (dp_idx + 1) * (n_pairs // dp)]})
        _barrier()
        if not st3.all_done(dp):
            raise RuntimeError(f"stage-3 store {root}: writers missing "
                               f"(the ranks need a shared filesystem)")
        d3_r = st3.read("Distance")
        _barrier()
    finally:
        if mesh.rank == 0:
            shutil.rmtree(root, ignore_errors=True)
    blk = slice(dp_idx * (n_pairs // dp), (dp_idx + 1) * (n_pairs // dp))
    assert np.array_equal(d3_r[blk], d3_rows)

    pos3 = shard_distance_matrix(d3_r[labels3 == 1], mesh)
    neg3 = shard_distance_matrix(d3_r[labels3 == 0], mesh)
    rows3 = draw_dp_rows(gen, mesh, 2, pos3.shape[0], neg3.shape[0], 2)
    st_d = pr_train_chunk_sharded(mesh, pos3, neg3, mu, gamma,
                                  pr_init(pos3.shape[1], 1, device=dev),
                                  rows3, batch_per_device=2, n_steps=2)
    assert st_d.t == 2 * 2 * dp, st_d.t

    w_rows = torch.cat([st_d.w, torch.ones_like(st_d.w)], dim=0)
    fpr95_3, auc_3 = pr_stats_sharded(
        mesh, shard_distance_matrix(d3_r, mesh),
        rows_dp.shard(labels3 == 1), w_rows)
    assert fpr95_3.shape == (2,) and bool(torch.isfinite(auc_3).all())

    # PJ: batch rows over dp, all_gather violators, psum dLoss, eigh on all
    f_pj = 32
    pos_pj = rows_dp.shard(0.3 * torch.randn((n_rows, f_pj), generator=gen))
    neg_pj = rows_dp.shard(torch.randn((n_rows, f_pj), generator=gen))
    rows_pj = draw_dp_rows(gen, mesh, 1, pos_pj.shape[0], neg_pj.shape[0], 4)
    st_pj = pj_train_chunk_sharded(mesh, pos_pj, neg_pj, 0.001, 0.5,
                                   pj_init(f_pj, device=dev), rows_pj,
                                   batch_per_device=4, n_steps=1)
    assert st_pj.t == 1

    # SLAM back end (BASELINE config 5): edge-sharded Sim(3) pose graph
    m_nodes = max(4, n_ranks)
    angles = torch.linspace(0.0, 0.5, m_nodes, device=dev)
    zeros = torch.zeros_like(angles)
    r0 = so3_exp(torch.stack([zeros, angles, zeros], -1))
    t0 = torch.stack([angles, zeros, 2.0 * angles], -1)
    ei = torch.arange(m_nodes - 1, device=dev)
    rz = torch.einsum("nij,nik->njk", r0[:-1], r0[1:])
    tz = torch.einsum("nij,ni->nj", r0[:-1], t0[1:] - t0[:-1])
    pg = optimize_pose_graph_sim3_sharded(mesh, r0, t0, ei, ei + 1, rz, tz,
                                          n_iters=2)
    assert bool(torch.isfinite(pg.cost_history).all())

    # windowed-BA map block: landmark-sharded multi-view BA over dp
    n_cam, n_lm = 3, 8 * dp
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(-2, 2, n_lm), rng.uniform(-1, 1, n_lm),
                    rng.uniform(5, 9, n_lm)], 1).astype(np.float32)
    rs = so3_exp(torch.tensor([[0.0, 0.03 * c, 0.0] for c in range(n_cam)]))
    rs = rs.numpy().astype(np.float32)
    ts = np.asarray([[-0.3 * c, 0.0, 0.0] for c in range(n_cam)],
                    np.float32)
    cam = np.repeat(np.arange(n_cam, dtype=np.int32), n_lm)
    pt = np.tile(np.arange(n_lm, dtype=np.int32), n_cam)
    q = np.einsum("cij,nj->cni", rs, pts) + ts[:, None, :]
    uv = (q[..., :2] / q[..., 2:3]).reshape(-1, 2).astype(np.float32)
    sh = shard_ba_problem(pts, cam, pt, uv, np.ones(len(cam), np.float32),
                          dp)
    mine = {k: v[dp_idx] for k, v in sh.items()
            if isinstance(v, np.ndarray)}
    ba = multi_view_ba_sharded(mesh, torch.from_numpy(rs).to(dev),
                               torch.from_numpy(ts).to(dev), mine,
                               n_iters=2)
    assert bool(torch.isfinite(ba.cost_history).all())

    return dict(mesh=mesh.shape, pr_t=st.t, obj=float(obj[0]), pj_t=st_pj.t,
                pg_cost=float(pg.cost_history[-1]),
                mvba_cost=float(ba.cost_history[-1]),
                stage3=(n_pairs, n_rings3), pr_on_stage3_t=st_d.t,
                stats_fpr95=float(fpr95_3[0]))


def summary_line(s: dict) -> str:
    """The JAX dry run's one-line report."""
    return (f"dryrun_multichip ok: mesh {s['mesh']} pr.t={s['pr_t']} "
            f"obj={s['obj']:.4f} pj.t={s['pj_t']} "
            f"pg_cost={s['pg_cost']:.3e} mvba_cost={s['mvba_cost']:.3e} "
            f"stage3={s['stage3']} store_roundtrip=ok "
            f"pr_on_stage3.t={s['pr_on_stage3_t']} "
            f"stats_fpr95={s['stats_fpr95']:.3f}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (nccl) or cpu (gloo)")
    args = p.parse_args(argv)
    print(summary_line(dryrun_multichip(args.device)), flush=True)


if __name__ == "__main__":
    main()
