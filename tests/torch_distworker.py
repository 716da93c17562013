"""One rank of a gloo process group for the port's multi-device tests.

Not a test file: tests/test_torch_parallel.py and
tests/test_torch_shard_store.py start one world of these processes per
file (module-scoped fixture), with MASTER_ADDR/MASTER_PORT and
DLCO_NUM_PROCESSES/DLCO_PROCESS_ID in the environment, so
``distributed_init`` runs from the environment. Each rank runs every step
of its suite on the inputs the test wrote (``<dir>/inputs.npz``) and saves
what it computed to ``<dir>/rank<r>.npz``. Imports torch and the port
only: the tests hold the saved outputs against the JAX package.

    python tests/torch_distworker.py {parallel|store|cuda} <dir>

The "cuda" suite runs its ranks on one card over gloo (the card tests of
tests/test_torch_cuda.py).
"""

import json
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opencv_dlco_tpu_torch.parallel.distributed import (  # noqa: E402
    distributed_init,
    host_info,
)
from opencv_dlco_tpu_torch.parallel.mesh import (  # noqa: E402
    RankSlot,
    data_axis,
    make_mesh,
    model_axis,
)


def _t(x):
    return torch.from_numpy(np.asarray(x))


class Replay:
    """Draw functions that hand out recorded draws in order (the JAX key
    schedule's, computed by the test)."""

    def __init__(self, *draws):
        self.draws = list(draws)

    def __call__(self, *args):
        return self.draws.pop(0)


def suite_parallel(inp, out, dev, work):
    """(2, 2) mesh over 4 ranks: each sharded function on its block."""
    from opencv_dlco_tpu_torch.geometry.mvba import multi_view_ba_sharded
    from opencv_dlco_tpu_torch.geometry.posegraph import (
        optimize_pose_graph_sharded, optimize_pose_graph_sim3_sharded)
    from opencv_dlco_tpu_torch.models import pj_rda, pr_rda
    from opencv_dlco_tpu_torch.models.pj_rda import PJState, pj_init
    from opencv_dlco_tpu_torch.models.pr_rda import PRState, pr_init
    from opencv_dlco_tpu_torch.parallel.dryrun import dryrun_multichip
    from opencv_dlco_tpu_torch.parallel.sharding import (
        Sharding, pj_sweep_chunk_sharded, pj_train_chunk_sharded,
        pr_stats_sharded, pr_sweep_chunk_sharded, pr_train_chunk_sharded,
        pr_validate_sharded, ring_distances_sharded, shard_distance_matrix)
    from opencv_dlco_tpu_torch.pipeline import slam

    mesh = make_mesh(dp=2, mp=2, device=dev)
    out["ranks"] = mesh.ranks
    out["coords"] = np.asarray([mesh.axis_index(data_axis),
                                mesh.axis_index(model_axis)])
    dp_idx = mesh.axis_index(data_axis)
    by_dp = Sharding(mesh, (data_axis,))

    # a layout whose mesh rows and columns run against global rank order
    # (host 0 = ranks {3, 2}, host 1 = {1, 0}), with real groups: gathers
    # come back in axis order, not in group-rank order
    perm = make_mesh(2, 2, device=dev, devices=[
        RankSlot(r, h, i)
        for r, (h, i) in enumerate([(1, 1), (1, 0), (0, 1), (0, 0)])])
    me = torch.tensor([float(perm.rank)])
    out["perm_ranks"] = perm.ranks
    out["perm_gather"] = torch.stack([perm.all_gather(me, data_axis),
                                      perm.all_gather(me, model_axis)]).numpy()
    out["perm_psum"] = torch.cat([perm.psum(me, data_axis),
                                  perm.psum(me, model_axis)]).numpy()

    out["ring"] = ring_distances_sharded(
        mesh, Sharding(mesh, (model_axis,)).shard(inp["filters"]),
        by_dp.shard(inp["pt1"]), by_dp.shard(inp["pt2"])).numpy()

    fpr95, auc = pr_stats_sharded(
        mesh, shard_distance_matrix(inp["st_dists"], mesh),
        by_dp.shard(inp["st_labels"]),
        Sharding(mesh, (None, model_axis)).shard(inp["st_w"]))
    out["stats"] = torch.stack([fpr95, auc]).numpy()

    pos, neg = (shard_distance_matrix(inp[k], mesh)
                for k in ("pr_pos", "pr_neg"))
    mu, gamma = _t(inp["pr_mu"]), _t(inp["pr_gamma"])
    rows = (_t(inp["pr_ip"][dp_idx]), _t(inp["pr_ineg"][dp_idx]))
    n_steps, bpd = rows[0].shape
    st = pr_train_chunk_sharded(mesh, pos, neg, mu, gamma,
                                pr_init(pos.shape[1], 1, device=dev), rows,
                                batch_per_device=bpd, n_steps=n_steps)
    out["pr_w"], out["pr_df"], out["pr_t"] = (st.w.numpy(),
                                              st.df_avg.numpy(), st.t)
    val = pr_validate_sharded(mesh, pos, neg, mu, st)
    out["pr_val"] = torch.stack([v.to(torch.float64) for v in val]).numpy()

    pos_pj, neg_pj = (by_dp.shard(inp[k]) for k in ("pj_pos", "pj_neg"))
    rows = (_t(inp["pj_ip"][dp_idx]), _t(inp["pj_ineg"][dp_idx]))
    n_steps, bpd = rows[0].shape
    st = pj_train_chunk_sharded(mesh, pos_pj, neg_pj, 0.001, 0.5,
                                pj_init(pos_pj.shape[1], device=dev), rows,
                                batch_per_device=bpd, n_steps=n_steps)
    out["pj_w"], out["pj_a"], out["pj_t"] = st.w.numpy(), st.a.numpy(), st.t

    # sweeps over dp: the single-device draws, replayed
    draws = pr_rda.draw_gather_rows, pj_rda.draw_sweep_rows
    pr_rda.draw_gather_rows = Replay((_t(inp["sw_ip"]), _t(inp["sw_ineg"])))
    s, f = inp["sw_mus"].shape[0], inp["sw_pos"].shape[1]
    zeros = torch.zeros((s, f))
    st = pr_sweep_chunk_sharded(
        mesh, _t(inp["sw_pos"]), _t(inp["sw_neg"]), _t(inp["sw_mus"]),
        _t(inp["sw_gammas"]), PRState(w=zeros, df_avg=zeros.clone(), t=0),
        torch.Generator(), batch=int(inp["sw_batch"]),
        n_steps=inp["sw_ip"].shape[0])
    out["sw_w"], out["sw_df"] = st.w.numpy(), st.df_avg.numpy()

    pj_rda.draw_sweep_rows = Replay((_t(inp["pjs_ip"]),
                                     _t(inp["pjs_ineg"])))
    s, f = inp["pjs_mus"].shape[0], inp["pjs_pos"].shape[1]
    st = pj_sweep_chunk_sharded(
        mesh, _t(inp["pjs_pos"]), _t(inp["pjs_neg"]), _t(inp["pjs_mus"]),
        _t(inp["pjs_gammas"]), pj_rda.pj_init_batch(f, s, device=dev),
        torch.Generator(), batch=int(inp["pjs_batch"]),
        n_steps=inp["pjs_ip"].shape[1])
    out["pjs_w"], out["pjs_a"], out["pjs_t"] = (st.w.numpy(), st.a.numpy(),
                                                st.t)
    assert isinstance(st, PJState)
    pr_rda.draw_gather_rows, pj_rda.draw_sweep_rows = draws

    g = [_t(inp[k]) for k in ("pg_r0", "pg_t0", "pg_ei", "pg_ej", "pg_rz",
                              "pg_tz")]
    pg = optimize_pose_graph_sharded(mesh, *g, n_iters=int(inp["pg_iters"]))
    out["pg_r"], out["pg_t"], out["pg_cost"] = (
        pg.r.numpy(), pg.t.numpy(), pg.cost_history.numpy())
    g[5] = _t(inp["pg3_tz"])
    pg = optimize_pose_graph_sim3_sharded(mesh, *g,
                                          n_iters=int(inp["pg_iters"]))
    out["pg3_r"], out["pg3_t"], out["pg3_s"], out["pg3_cost"] = (
        pg.r.numpy(), pg.t.numpy(), pg.s.numpy(), pg.cost_history.numpy())

    shard = {k[3:]: inp[k][dp_idx] for k in inp.files
             if k.startswith("ba_") and k not in ("ba_r0", "ba_t0",
                                                  "ba_iters")}
    ba = multi_view_ba_sharded(mesh, _t(inp["ba_r0"]), _t(inp["ba_t0"]),
                               shard, n_iters=int(inp["ba_iters"]))
    out["ba_r"], out["ba_t"], out["ba_points"], out["ba_cost"] = (
        ba.r.numpy(), ba.t.numpy(), ba.points.numpy(),
        ba.cost_history.numpy())

    # the SLAM back end over the mesh on exact-geometry features
    feats = [tuple(inp[f"slam_f{i}_{j}"] for j in range(3))
             for i in range(int(inp["slam_n"]))]
    slam.compute_features = lambda *a, **kw: feats
    # windowed_ba's and the pose graph's inputs (pickled by rank 0 for the
    # test's JAX calls on the same inputs) and outputs
    calls = {}

    def recorder(name, inner):
        def record(*a, **kw):
            calls[name] = (a, {k: v for k, v in kw.items()
                               if k not in ("device", "mesh")},
                           inner(*a, **kw))
            return calls[name][2]
        return record

    for name in ("windowed_ba", "refine_with_pose_graph"):
        setattr(slam, name, recorder(name, getattr(slam, name)))
    res = slam.run_slam([None] * len(feats), tuple(inp["slam_intr"]), None,
                        slam.SlamConfig(**json.loads(str(inp["slam_cfg"]))),
                        device=dev, mesh=make_mesh(2, 2, device=dev))
    out["slam_r"], out["slam_t"] = res.rotations, res.translations
    pg = calls["refine_with_pose_graph"][2]
    out["slam_pg_r"], out["slam_pg_t"] = pg.rotations, pg.translations
    out["slam_windows"] = json.dumps(
        {str(k): [np.asarray(v[0]).tolist(), np.asarray(v[1]).tolist()]
         for k, v in calls["windowed_ba"][2].items()})
    if mesh.rank == 0:
        with open(os.path.join(work, "slam_calls.pkl"), "wb") as fh:
            pickle.dump({k: v[:2] for k, v in calls.items()}, fh)

    out["dryrun"] = json.dumps(dryrun_multichip(dev))


def suite_store(inp, out, dev, work):
    """2 ranks: concurrent writers, the sharded sweep checkpoint, stage 3
    sharded and a multi-process PR sweep."""
    import torch.distributed as dist

    from opencv_dlco_tpu_torch.data.shard_store import (ShardedArrayStore,
                                                        shard_rows)
    from opencv_dlco_tpu_torch.models.pr_rda import PRState
    from opencv_dlco_tpu_torch.parallel.sweep import (SweepInterrupted,
                                                      run_pr_sweep)
    from opencv_dlco_tpu_torch.pipeline.stages import Workspace
    from opencv_dlco_tpu_torch.utils.checkpoint import ShardedSweepCheckpoint
    from opencv_dlco_tpu_torch.utils.configs import (PoolRegionConfig,
                                                     PRLearnConfig,
                                                     PRSweepGrid)

    rank, n = dist.get_rank(), dist.get_world_size()
    root = str(inp["root"])

    # two writers of one store at once, each its own chunk-aligned rows
    st = ShardedArrayStore(os.path.join(root, "conc"))
    st.create("D", (96, 16), np.float32, chunk_rows=8)
    lo, hi = shard_rows(96, 8, rank, n)
    dist.barrier()
    st.write_rows("D", lo, np.arange(lo, hi, dtype=np.float32)[:, None]
                  * np.ones(16, np.float32))
    st.mark_done(rank, {"rows": [lo, hi]})

    # sharded sweep checkpoint: rank 1's file lags a wave
    ck = ShardedSweepCheckpoint(os.path.join(root, "ck", "sweep"), rank, n,
                                4)
    sig = {"grid": 4}

    def wave(k):
        w = torch.full((4, 3), float(k)) + torch.arange(4.0)[:, None]
        return PRState(w=w, df_avg=-w, t=100 * k)

    gen = torch.Generator().manual_seed(5)
    ck.save(wave(1), gen, {"best": np.full(4, 1.0)}, sig, 1)
    torch.randint(0, 10, (3,), generator=gen)
    dist.barrier()
    if rank == 0:
        ck.save(wave(2), gen, {"best": np.full(4, 2.0)}, sig, 2)
    dist.barrier()
    st_l, gen_l, arrs, wave_l = ck.load(PRState, sig, device=dev)
    out["ck_lag"] = np.concatenate([[wave_l, st_l.t], st_l.w.numpy().ravel(),
                                    arrs["best"]])
    out["ck_lag_draw"] = torch.randint(0, 10**6, (4,),
                                       generator=gen_l).numpy()
    dist.barrier()
    if rank == 1:
        ck.save(wave(2), gen, {"best": np.full(4, 2.0)}, sig, 2)
    dist.barrier()
    st_l, _, arrs, wave_l = ck.load(PRState, sig, device=dev)
    out["ck_caught_up"] = np.concatenate(
        [[wave_l, st_l.t], st_l.w.numpy().ravel(), arrs["best"]])
    dist.barrier()
    ck.cleanup()

    # stage 3 sharded on the test's workspace, then the PR sweep on it:
    # interrupted after one log period, resumed from the sharded sidecar
    ws = Workspace(os.path.join(root, "ws"),
                   pool_cfg=PoolRegionConfig(**json.loads(str(inp["pool"]))),
                   pair_block=int(inp["pair_block"]), progress=False,
                   device=dev)
    out["dist_path"] = ws.compdist("synth", sharded=True)
    grid = PRSweepGrid(**json.loads(str(inp["grid"])))
    base = PRLearnConfig(**json.loads(str(inp["pr"])))
    try:
        run_pr_sweep(ws, "synth", grid, base, _stop_after_logs=1)
        raise AssertionError("the sweep was not interrupted")
    except SweepInterrupted:
        pass
    dist.barrier()
    out["sidecars"] = json.dumps(sorted(
        f for f in os.listdir(ws.path("pr-learn")) if "sweep-ckpt" in f))
    dist.barrier()
    out["sweep"] = json.dumps(run_pr_sweep(ws, "synth", grid, base))
    dist.barrier()


class World:
    """``n`` ranks of ``suite`` on ``work``/inputs.npz over gloo on a free
    localhost port, started at construction; ``ranks()`` waits for all
    (killing all if one fails or the time runs out) and returns each
    rank's saved outputs. The test process computes its references while
    the world runs."""

    def __init__(self, n: int, suite: str, work: str,
                 timeout: float = 240.0):
        import socket
        import subprocess

        self.n, self.suite, self.work = n, suite, work
        self.timeout = timeout
        self._out = None
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        self.procs = []
        for rank in range(n):
            env = dict(os.environ, MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), DLCO_NUM_PROCESSES=str(n),
                       DLCO_PROCESS_ID=str(rank), OMP_NUM_THREADS="1")
            env.pop("DLCO_COORDINATOR", None)
            with open(os.path.join(work, f"rank{rank}.log"), "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), suite, work],
                    env=env, stdout=log, stderr=subprocess.STDOUT))

    def ranks(self) -> list:
        if self._out is None:
            try:
                for proc in self.procs:
                    proc.wait(timeout=self.timeout)
            finally:
                for proc in self.procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            bad = [r for r, p in enumerate(self.procs) if p.returncode]
            if bad:
                with open(os.path.join(self.work,
                                       f"rank{bad[0]}.log")) as fh:
                    raise RuntimeError(
                        f"ranks {bad} of the {self.suite} world failed:\n"
                        + fh.read()[-4000:])
            self._out = [dict(np.load(os.path.join(self.work,
                                                   f"rank{r}.npz")))
                         for r in range(self.n)]
        return self._out


def suite_cuda(inp, out, dev, work):
    """2 ranks on one card over gloo: collectives of CUDA tensors, the
    sweep chunk over dp through kernel B, the dry run."""
    import torch.distributed as dist

    from opencv_dlco_tpu_torch.models.pr_rda import PRState
    from opencv_dlco_tpu_torch.ops import fused_rda
    from opencv_dlco_tpu_torch.parallel.dryrun import dryrun_multichip
    from opencv_dlco_tpu_torch.parallel.sharding import (
        pr_sweep_chunk_sharded)

    mesh = make_mesh(dp=2, mp=1, device=dev)
    x = torch.arange(4.0, device=dev) + 10 * dist.get_rank()
    out["psum"] = mesh.psum(x, data_axis).cpu().numpy()
    out["gather"] = mesh.all_gather(x, data_axis).cpu().numpy()
    pos, neg = (_t(inp[k]).to(dev).to(torch.bfloat16)
                for k in ("pos", "neg"))
    s, f = inp["mus"].shape[0], pos.shape[1]
    zeros = torch.zeros((s, f), device=dev)
    fused_rda.fused_block_train_wide.launches = 0
    st = pr_sweep_chunk_sharded(
        mesh, pos, neg, _t(inp["mus"]).to(dev), _t(inp["gammas"]).to(dev),
        PRState(w=zeros, df_avg=zeros.clone(), t=0),
        torch.Generator().manual_seed(int(inp["seed"])),
        batch=int(inp["batch"]), n_steps=int(inp["n_steps"]),
        sampling="block_fused", precision="default")
    out["B_launches"] = fused_rda.fused_block_train_wide.launches
    out["sw_w"], out["sw_df"] = st.w.cpu().numpy(), st.df_avg.cpu().numpy()
    out["dryrun"] = json.dumps(dryrun_multichip(dev))


def main() -> None:
    suite, work = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    dev = "cuda" if suite == "cuda" else "cpu"
    multi = distributed_init(backend="gloo", device=dev)
    info = host_info(dev)
    out = {"multi": multi, "info": json.dumps(info)}
    with np.load(os.path.join(work, "inputs.npz")) as inp:
        {"parallel": suite_parallel, "store": suite_store,
         "cuda": suite_cuda}[suite](inp, out, dev, work)
    np.savez(os.path.join(work, f"rank{info['process_index']}.npz"), **out)


if __name__ == "__main__":
    main()
