"""The port's multi-device layer against the JAX package, on the CPU.

One gloo world of 4 processes (tests/torch_distworker.py, suite
"parallel") runs every sharded function of the port on a (2, 2) mesh;
the JAX package runs the same functions in-process on a (2, 2) mesh of 4
of conftest.py's 8 CPU devices, on the same numpy inputs and with JAX's
draws (fold_in(key, dp_index), split, randint: parallel/sharding.py:126-134
of the JAX package). Tolerances are the JAX suite's sharded-vs-single ones
(tests/test_parallel.py, tests/test_mvba.py, tests/test_slam.py:324).
"""

import functools
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from opencv_dlco_tpu.geometry import mvba as jmvba
from opencv_dlco_tpu.geometry import posegraph as jpg
from opencv_dlco_tpu.geometry.se3 import so3_exp
from opencv_dlco_tpu.models.pj_rda import pj_init as jax_pj_init
from opencv_dlco_tpu.models.pj_rda import pj_init_batch as jax_pj_init_batch
from opencv_dlco_tpu.models.pr_rda import pr_init as jax_pr_init
from opencv_dlco_tpu.ops.patch_transform import batch_patch_transform
from opencv_dlco_tpu.ops.pool_regions import build_filter_bank
from opencv_dlco_tpu.parallel import sharding as jsh
from opencv_dlco_tpu.parallel.mesh import make_mesh as jax_make_mesh
from opencv_dlco_tpu.pipeline import slam as js
from opencv_dlco_tpu.utils.configs import PoolRegionConfig

from opencv_dlco_tpu_torch.geometry import posegraph as port_pg
from opencv_dlco_tpu_torch.geometry import se3 as port_se3
from opencv_dlco_tpu_torch.models import pj_rda as port_pj
from opencv_dlco_tpu_torch.models import pr_rda as port_pr
from opencv_dlco_tpu_torch.models.pr_rda import PRState, pr_train_chunk
from opencv_dlco_tpu_torch.parallel import distributed
from opencv_dlco_tpu_torch.parallel.mesh import RankSlot, make_mesh

from oracles import random_patches
from synth import synth_pj_dataset, synth_pr_dataset
from test_torch_slam import SLAM_CFG, scene_features
from torch_distworker import World

DP, MP = 2, 2
PR_KEY, PJ_KEY, SW_KEY, PJS_KEY = 0, 1, 5, 9


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _rows(keys, fold, n_steps, n_pos, n_neg, batch):
    """Row draws from each key of ``keys`` (K,): one key per step, split
    into the positive and negative draws (the gather scans of the JAX
    models); with ``fold`` >= 0 each step key is first fold_in(key, fold),
    the dp index of the JAX sharded chunks. (K, n_steps, batch) per side."""
    def draw(k):
        k = jnp.where(fold >= 0, jax.random.fold_in(k, fold), k)
        kp, kn = jax.random.split(k)
        return (jax.random.randint(kp, (batch,), 0, n_pos),
                jax.random.randint(kn, (batch,), 0, n_neg))

    return jax.vmap(lambda key: jax.vmap(draw)(
        jax.random.split(key, n_steps)))(keys)


def _dp_rows(key, n_steps, n_local_pos, n_local_neg, bpd):
    """The rows each dp index draws in the JAX sharded PR/PJ chunk
    (parallel/sharding.py:126-134 of the JAX package): (dp, n_steps, bpd)
    per side."""
    keys = jax.random.PRNGKey(key)[None]
    ip, ineg = zip(*(_rows(keys, d, n_steps, n_local_pos, n_local_neg, bpd)
                     for d in range(DP)))
    return (np.concatenate(ip).astype(np.int64),
            np.concatenate(ineg).astype(np.int64))


def _loop_graph(m=20, n_loops=2, seed=3):
    """tests/test_parallel.py's noisy odometry loop + exact closures (built
    in f64 with the port's SE(3) functions)."""
    rng = np.random.default_rng(seed)

    def exp(xi):
        return port_se3.se3_exp(torch.tensor(xi, dtype=torch.float64))

    def compose(a, b):
        return port_se3.se3_compose(*a, *b)

    step = exp([0.5, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / m])
    gt = [(torch.eye(3, dtype=torch.float64),
           torch.zeros(3, dtype=torch.float64))]
    for _ in range(1, m):
        gt.append(compose(gt[-1], step))

    def rel(i, j):
        return compose(port_se3.se3_inverse(*gt[i]), gt[j])

    ei, ej, zs = [], [], []
    init = [gt[0]]
    for i in range(m - 1):
        z = compose(rel(i, i + 1), exp(rng.normal(size=6) * 0.01))
        ei.append(i)
        ej.append(i + 1)
        zs.append(z)
        init.append(compose(init[-1], z))
    for k in range(n_loops):
        i, j = sorted((k * (m // n_loops), (k * (m // n_loops) + m // 2) % m))
        ei.append(i)
        ej.append(j)
        zs.append(rel(i, j))

    def f32(xs):
        return torch.stack(xs).numpy().astype(np.float32)

    return dict(pg_r0=f32([r for r, _ in init]),
                pg_t0=f32([t for _, t in init]),
                pg_ei=np.asarray(ei, np.int64), pg_ej=np.asarray(ej, np.int64),
                pg_rz=f32([r for r, _ in zs]), pg_tz=f32([t for _, t in zs]))


def _ba_problem(rng, m=4, n=64, noise=5e-4, obs_frac=0.8):
    """tests/test_mvba.py's arc of cameras over a point field, perturbed."""
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(6, 12, n)], 1)
    rs = np.stack([np.asarray(so3_exp(jnp.asarray([0.0, 0.04 * i, 0.0])))
                   for i in range(m)])
    ts = np.stack([[-0.4 * i, 0.02 * i, 0.0] for i in range(m)])
    cam, pt, uv = [], [], []
    for c in range(m):
        q = pts @ rs[c].T + ts[c]
        proj = q[:, :2] / q[:, 2:3]
        for p in np.flatnonzero(rng.random(n) < obs_frac):
            cam.append(c)
            pt.append(p)
            uv.append(proj[p] + rng.normal(0, noise, 2))
    rs0 = np.stack([np.asarray(so3_exp(jnp.asarray(rng.normal(size=3)
                                                   * 0.01))) @ rs[i]
                    for i in range(m)])
    ts0 = ts + rng.normal(0, 0.03, ts.shape)
    rs0[0], ts0[0] = rs[0], ts[0]
    pts0 = pts + rng.normal(0, 0.05, pts.shape)
    return (rs0.astype(np.float32), ts0.astype(np.float32),
            pts0.astype(np.float32), np.asarray(cam, np.int32),
            np.asarray(pt, np.int32), np.asarray(uv, np.float32))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(2215)
    _, _, filters = build_filter_bank(PoolRegionConfig(nr=4, nphi=2,
                                                       nsigma=2))
    pt = np.asarray(batch_patch_transform(jnp.asarray(random_patches(rng,
                                                                     16))))
    inp = dict(filters=filters.astype(np.float32), pt1=pt[:8], pt2=pt[8:])
    inp.update(st_dists=np.abs(rng.normal(1.0, 0.5, (64, 16))).astype(
        np.float32), st_labels=rng.integers(0, 2, 64).astype(bool),
        st_w=np.abs(rng.normal(0.5, 0.3, (3, 16))).astype(np.float32))

    pos, neg, _ = synth_pr_dataset(rng, n_pos=256, n_neg=256, n_feat=64)
    inp.update(pr_pos=pos, pr_neg=neg,
               pr_mu=np.asarray([0.02], np.float32),
               pr_gamma=np.asarray([0.25], np.float32))
    inp["pr_ip"], inp["pr_ineg"] = _dp_rows(PR_KEY, 20, 128, 128, 16)
    pos, neg, _ = synth_pj_dataset(rng, n_pos=128, n_neg=128, n_feat=32)
    inp.update(pj_pos=pos, pj_neg=neg)
    inp["pj_ip"], inp["pj_ineg"] = _dp_rows(PJ_KEY, 5, 64, 64, 16)

    r2 = np.random.default_rng(41)
    inp.update(
        sw_pos=np.abs(r2.normal(1.0, 0.5, (128, 64))).astype(np.float32),
        sw_neg=np.abs(r2.normal(1.2, 0.5, (128, 64))).astype(np.float32),
        sw_mus=np.linspace(0.005, 0.05, 16).astype(np.float32),
        sw_gammas=np.linspace(0.02, 0.2, 16).astype(np.float32),
        sw_batch=np.int64(32))
    ip, ineg = _rows(jax.random.PRNGKey(SW_KEY)[None], -1, 6, 128, 128, 32)
    inp["sw_ip"], inp["sw_ineg"] = np.asarray(ip[0]), np.asarray(ineg[0])
    r3 = np.random.default_rng(17)
    inp.update(
        pjs_pos=r3.normal(0, 0.3, (128, 16)).astype(np.float32),
        pjs_neg=r3.normal(0, 1.0, (128, 16)).astype(np.float32),
        pjs_mus=np.linspace(1e-4, 1e-3, 4).astype(np.float32),
        pjs_gammas=np.linspace(0.02, 0.2, 4).astype(np.float32),
        pjs_batch=np.int64(32))
    ip, ineg = _rows(jax.random.split(jax.random.PRNGKey(PJS_KEY), 4), -1,
                     3, 128, 128, 32)
    inp["pjs_ip"], inp["pjs_ineg"] = np.asarray(ip), np.asarray(ineg)

    inp.update(_loop_graph(), pg_iters=np.int64(15))
    # monocular scale drift on the odometry edges for the Sim(3) graph
    inp["pg3_tz"] = inp["pg_tz"].copy()
    inp["pg3_tz"][:19] *= np.exp(0.02 * np.arange(19))[:, None].astype(
        np.float32)

    rs0, ts0, pts0, cam, pt_i, uv = _ba_problem(np.random.default_rng(13))
    sh = jmvba.shard_ba_problem(pts0, cam, pt_i, uv,
                                np.ones(len(cam), np.float32), DP)
    inp.update(ba_r0=rs0, ba_t0=ts0, ba_iters=np.int64(8),
               **{f"ba_{k}": v for k, v in sh.items()
                  if isinstance(v, np.ndarray)})
    ba_single = dict(rs0=rs0, ts0=ts0, pts0=pts0, cam=cam, pt=pt_i, uv=uv)

    feats, gt, intr = scene_features(n_frames=8)
    inp.update(slam_n=np.int64(len(feats)), slam_intr=np.asarray(intr),
               slam_cfg=json.dumps(SLAM_CFG))
    for i, f in enumerate(feats):
        for j, a in enumerate(f):
            inp[f"slam_f{i}_{j}"] = a
    return inp, ba_single


@pytest.fixture(scope="module")
def world_run(inputs, tmp_path_factory):
    """The 4-rank world, running while the tests compute their JAX
    references (each test reads ``world_run.ranks()`` after its own; the
    tests with the longest references come first)."""
    work = str(tmp_path_factory.mktemp("parallel_world"))
    np.savez(os.path.join(work, "inputs.npz"), **inputs[0])
    w = World(DP * MP, "parallel", work)
    yield w
    w.ranks()


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(dp=DP, mp=MP, devices=jax.devices()[:DP * MP])


def _assemble(world, key):
    """The global array from each rank's (dp, mp) block of ``key``."""
    blocks = {tuple(r["coords"]): r[key] for r in world}
    return np.block([[blocks[(d, m)] for m in range(MP)] for d in range(DP)])


def _mp_columns(world, key):
    """A state replicated over dp and split over mp, whole: the mp blocks
    concatenated (every dp row holding the same)."""
    blocks = {tuple(r["coords"]): r[key] for r in world}
    for d in range(1, DP):
        for m in range(MP):
            np.testing.assert_array_equal(blocks[(d, m)], blocks[(0, m)])
    return np.concatenate([blocks[(0, m)] for m in range(MP)], axis=-1)


def _same_on_every_rank(world, key):
    for r in world[1:]:
        np.testing.assert_array_equal(r[key], world[0][key])
    return world[0][key]


def _close(ours, ref, what, rel=1e-4):
    """max |ours - ref| <= rel x max |ref|: the port-vs-JAX PJ tolerance of
    tests/test_torch_pj.py (two eigh implementations)."""
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ours - np.asarray(ref)).max())
    assert err <= rel * scale, f"{what}: max err {err} vs scale {scale}"


@pytest.mark.parametrize("sim3", [False, True], ids=["se3", "sim3"])
def test_pose_graph_sharded_matches_jax(world_run, inputs, jmesh, sim3):
    """Against the JAX edge-sharded solver (which the JAX suite holds to
    its dense one) and the port's single-device solver."""
    inp = inputs[0]
    pre = "pg3_" if sim3 else "pg_"
    keys = ("pg_r0", "pg_t0", "pg_ei", "pg_ej", "pg_rz", pre + "tz")
    args = [jnp.asarray(inp[k]) for k in keys]
    args[2:4] = [a.astype(jnp.int32) for a in args[2:4]]
    ref = (jpg.optimize_pose_graph_sim3_sharded if sim3
           else jpg.optimize_pose_graph_sharded)(jmesh, *args, n_iters=15)
    one = (port_pg.optimize_pose_graph_sim3 if sim3
           else port_pg.optimize_pose_graph)(
        *(torch.from_numpy(inp[k]) for k in keys), n_iters=15)
    world = world_run.ranks()
    t = _same_on_every_rank(world, pre + "t")
    r = _same_on_every_rank(world, pre + "r")
    costs = _same_on_every_rank(world, pre + "cost")
    for want in (ref, one):
        np.testing.assert_allclose(t, np.asarray(want.t),
                                   atol=2e-3 if sim3 else 1e-3)
        np.testing.assert_allclose(r, np.asarray(want.r), atol=1e-3)
    if sim3:
        np.testing.assert_allclose(_same_on_every_rank(world, "pg3_s"),
                                   np.asarray(ref.s), atol=1e-3)
    assert np.isfinite(costs).all() and costs[-1] < costs[0] * 0.1


def test_multi_view_ba_sharded_matches_jax(world_run, inputs, jmesh):
    inp, single = inputs
    dp_sh = {k[3:]: jax.device_put(jnp.asarray(inp[k]),
                                   NamedSharding(jmesh, P("dp")))
             for k in ("ba_points", "ba_cam_idx", "ba_pt_idx", "ba_uv",
                       "ba_weights", "ba_table")}
    ref = jmvba.multi_view_ba_sharded(jmesh, jnp.asarray(inp["ba_r0"]),
                                      jnp.asarray(inp["ba_t0"]), dp_sh,
                                      n_iters=8)
    table, _ = jmvba.build_landmark_table(single["pt"],
                                          single["pts0"].shape[0])
    one = jmvba.multi_view_ba(*(jnp.asarray(single[k]) for k in
                                ("rs0", "ts0", "pts0", "cam", "pt", "uv")),
                              jnp.asarray(table), n_iters=8)
    world = world_run.ranks()
    np.testing.assert_allclose(_same_on_every_rank(world, "ba_r"),
                               np.asarray(ref.r), atol=1e-4)
    np.testing.assert_allclose(_same_on_every_rank(world, "ba_t"),
                               np.asarray(ref.t), atol=1e-4)
    pts = np.stack([next(r["ba_points"] for r in world
                         if r["coords"][0] == d) for d in range(DP)])
    np.testing.assert_allclose(pts, np.asarray(ref.points), atol=1e-3)
    costs = _same_on_every_rank(world, "ba_cost")
    np.testing.assert_allclose(costs, np.asarray(ref.cost_history),
                               rtol=1e-3)
    # and the unsharded problem's solution, landmark for landmark
    n = single["pts0"].shape[0]
    np.testing.assert_allclose(pts.reshape(-1, 3)[:n],
                               np.asarray(one.points), atol=1e-3)


def _jax_slam_result(res):
    """The port's SlamResult as the JAX package's (same fields)."""
    pairs = (None if p is None else [js.PairEstimate(**vars(e)) for e in p]
             for p in (res.pairs, res.bb_pairs))
    return js.SlamResult(**dict(vars(res), pairs=next(pairs),
                                bb_pairs=next(pairs)))


def test_slam_back_end_over_the_mesh_matches_jax(world_run, jmesh):
    """run_slam(mesh=(2, 2)) on exact-geometry features: windows dealt over
    dp, edge-sharded pose graph. On the trajectory, features and loops the
    ranks' back end passed to windowed_ba and refine_with_pose_graph
    (pickled by rank 0), JAX's windowed_ba(mesh=) and
    refine_with_pose_graph(mesh=) on a (2, 2) mesh give the ranks' window
    edges within 1e-4 and their refined poses within 1e-3
    (tests/test_slam.py's sharded-vs-single tolerances)."""
    world = world_run.ranks()
    with open(os.path.join(world_run.work, "slam_calls.pkl"), "rb") as fh:
        calls = pickle.load(fh)
    (traj, feats, intr, cfg), _ = calls["windowed_ba"]
    ref_windows = js.windowed_ba(_jax_slam_result(traj), feats, intr,
                                 js.SlamConfig(**vars(cfg)), mesh=jmesh)
    (traj,), kw = calls["refine_with_pose_graph"]
    ref_pg = js.refine_with_pose_graph(_jax_slam_result(traj), **kw,
                                       mesh=jmesh)

    windows = _same_on_every_rank(world, "slam_windows")
    windows = json.loads(str(windows))
    assert ref_windows and sorted(map(int, windows)) == sorted(ref_windows)
    for k, (r_z, t_z) in ref_windows.items():
        np.testing.assert_allclose(windows[str(k)][0], r_z, atol=1e-4)
        np.testing.assert_allclose(windows[str(k)][1], t_z, atol=1e-4)
    t = _same_on_every_rank(world, "slam_pg_t")
    np.testing.assert_allclose(t, ref_pg.translations, atol=1e-3)
    np.testing.assert_allclose(_same_on_every_rank(world, "slam_pg_r"),
                               ref_pg.rotations, atol=1e-3)
    # no backbone on this scene: run_slam returns the pose graph's poses
    assert traj.nodes is None
    np.testing.assert_array_equal(_same_on_every_rank(world, "slam_t"), t)


def test_pj_sweep_sharded_matches_single_device_and_jax(world_run, inputs,
                                                        jmesh, monkeypatch):
    inp = inputs[0]
    draws = (torch.from_numpy(inp["pjs_ip"]),
             torch.from_numpy(inp["pjs_ineg"]))
    monkeypatch.setattr(port_pj, "draw_sweep_rows", lambda *a: draws)
    one = port_pj.pj_train_chunk_batch(
        torch.from_numpy(inp["pjs_pos"]), torch.from_numpy(inp["pjs_neg"]),
        torch.from_numpy(inp["pjs_mus"]), torch.from_numpy(inp["pjs_gammas"]),
        port_pj.pj_init_batch(16, 4, device="cpu"), torch.Generator(),
        batch=32, n_steps=3)
    ref = jsh.pj_sweep_chunk_sharded(
        jmesh, jnp.asarray(inp["pjs_pos"]), jnp.asarray(inp["pjs_neg"]),
        jnp.asarray(inp["pjs_mus"]), jnp.asarray(inp["pjs_gammas"]),
        jax_pj_init_batch(16, 4),
        jax.random.split(jax.random.PRNGKey(PJS_KEY), 4), batch=32,
        n_steps=3)
    world = world_run.ranks()
    a = _same_on_every_rank(world, "pjs_a")
    w = _same_on_every_rank(world, "pjs_w")
    assert int(world[0]["pjs_t"]) == 3
    np.testing.assert_allclose(a, one.a.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w, one.w.numpy(), rtol=1e-5, atol=1e-6)
    _close(a, ref.a, "A")


def test_pj_train_sharded_matches_jax(world_run, inputs, jmesh):
    inp = inputs[0]
    row_sh = NamedSharding(jmesh, P("dp", None))
    st = jsh.pj_train_chunk_sharded(
        jmesh, jax.device_put(jnp.asarray(inp["pj_pos"]), row_sh),
        jax.device_put(jnp.asarray(inp["pj_neg"]), row_sh), 0.001, 0.5,
        jax_pj_init(32), jax.random.PRNGKey(PJ_KEY), batch_per_device=16,
        n_steps=5)
    world = world_run.ranks()
    a = _same_on_every_rank(world, "pj_a")
    w = _same_on_every_rank(world, "pj_w")
    assert int(world[0]["pj_t"]) == int(st.t) == 5
    _close(a, st.a, "A")
    # eigenvectors have no fixed sign: A = W^T W and ||Wx||^2 do not care
    np.testing.assert_allclose(a, w.T @ w, atol=5e-4)
    x = inp["pj_pos"][:64]
    _close(((x @ w.T) ** 2).sum(1), ((x @ np.asarray(st.w).T) ** 2).sum(1),
           "||Wx||^2")


def test_pr_sweep_over_dp_bit_equal_to_single_device(world_run, inputs, jmesh,
                                                     monkeypatch):
    inp = inputs[0]
    draws = (torch.from_numpy(inp["sw_ip"]), torch.from_numpy(inp["sw_ineg"]))
    monkeypatch.setattr(port_pr, "draw_gather_rows", lambda *a: draws)
    zeros = torch.zeros((16, 64))
    one = pr_train_chunk(torch.from_numpy(inp["sw_pos"]),
                         torch.from_numpy(inp["sw_neg"]),
                         torch.from_numpy(inp["sw_mus"]),
                         torch.from_numpy(inp["sw_gammas"]),
                         PRState(w=zeros, df_avg=zeros.clone(), t=0),
                         torch.Generator(), batch=32, n_steps=6)
    ref = jsh.pr_sweep_chunk_sharded(
        jmesh, jnp.asarray(inp["sw_pos"]), jnp.asarray(inp["sw_neg"]),
        jnp.asarray(inp["sw_mus"]), jnp.asarray(inp["sw_gammas"]),
        jax_pr_init(64, 16), jax.random.PRNGKey(SW_KEY), batch=32, n_steps=6)
    world = world_run.ranks()
    got_w = _same_on_every_rank(world, "sw_w")
    got_df = _same_on_every_rank(world, "sw_df")
    np.testing.assert_array_equal(got_w, one.w.numpy())
    np.testing.assert_array_equal(got_df, one.df_avg.numpy())
    np.testing.assert_allclose(got_w, np.asarray(ref.w), rtol=1e-5,
                               atol=1e-6)


def test_pr_train_and_validate_sharded_match_jax(world_run, inputs, jmesh):
    inp = inputs[0]
    pos = jsh.shard_distance_matrix(jnp.asarray(inp["pr_pos"]), jmesh)
    neg = jsh.shard_distance_matrix(jnp.asarray(inp["pr_neg"]), jmesh)
    mu, gamma = jnp.asarray(inp["pr_mu"]), jnp.asarray(inp["pr_gamma"])
    st = jsh.pr_train_chunk_sharded(jmesh, pos, neg, mu, gamma,
                                    jax_pr_init(64, 1),
                                    jax.random.PRNGKey(PR_KEY),
                                    batch_per_device=16, n_steps=20)
    world = world_run.ranks()
    assert all(int(r["pr_t"]) == int(st.t) == 16 * DP * 20 for r in world)
    np.testing.assert_allclose(_mp_columns(world, "pr_w"), np.asarray(st.w),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_mp_columns(world, "pr_df"),
                               np.asarray(st.df_avg), rtol=1e-4, atol=1e-6)
    loss, regul, obj, nnz = jsh.pr_validate_sharded(jmesh, pos, neg, mu, st)
    val = _same_on_every_rank(world, "pr_val")
    np.testing.assert_allclose(val[0], np.asarray(loss), rtol=1e-4)
    np.testing.assert_allclose(val[1], np.asarray(regul), rtol=1e-5)
    np.testing.assert_array_equal(val[3], np.asarray(nnz))


def test_world_mesh_layout_and_env_init(world_run):
    world = world_run.ranks()
    for rank, r in enumerate(world):
        assert bool(r["multi"])
        info = json.loads(str(r["info"]))
        assert info["process_index"] == rank and info["process_count"] == 4
        assert info["backend"] == "gloo"
        np.testing.assert_array_equal(r["ranks"], [[0, 1], [2, 3]])
        assert tuple(r["coords"]) == divmod(rank, MP)


def test_gathers_follow_the_axis_order_of_a_permuted_layout(world_run):
    """A (2, 2) mesh over a layout whose rows and columns descend in global
    rank ([[3, 2], [1, 0]]), with the world's real gloo groups: each rank's
    all_gather over dp returns its mesh column and over mp its mesh row, in
    axis order (torch's groups number their members in ascending rank)."""
    for rank, r in enumerate(world_run.ranks()):
        ranks = r["perm_ranks"]
        np.testing.assert_array_equal(ranks, [[3, 2], [1, 0]])
        d, m = (int(i[0]) for i in np.nonzero(ranks == rank))
        np.testing.assert_array_equal(r["perm_gather"][0], ranks[:, m])
        np.testing.assert_array_equal(r["perm_gather"][1], ranks[d, :])
        np.testing.assert_array_equal(
            r["perm_psum"], [ranks[:, m].sum(), ranks[d, :].sum()])


def test_make_mesh_orders_ranks_by_host():
    slots = [RankSlot(rank=r, host=h, local_id=i)
             for r, (h, i) in enumerate([(1, 1), (1, 0), (0, 1), (0, 0)])]
    mesh = make_mesh(dp=2, mp=2, devices=slots, device="cpu")
    # each dp row is one host, local ids in order: mp stays inside a host
    np.testing.assert_array_equal(mesh.ranks, [[3, 2], [1, 0]])
    assert mesh.shape == {"dp": 2, "mp": 2}


def test_make_mesh_rejects_mp_across_hosts():
    slots = [RankSlot(0, 0, 0), RankSlot(1, 1, 0)]
    with pytest.raises(ValueError, match="cross hosts"):
        make_mesh(dp=1, mp=2, devices=slots, device="cpu")
    with pytest.raises(ValueError, match="!= 2 ranks"):
        make_mesh(dp=3, mp=1, devices=slots, device="cpu")


def test_distributed_init_single_process_noop(monkeypatch):
    for var in ("DLCO_COORDINATOR", "DLCO_NUM_PROCESSES", "DLCO_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.distributed_init(device="cpu") is False
    assert distributed.distributed_init(num_processes=1,
                                        device="cpu") is False
    info = distributed.host_info("cpu")
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["backend"] == "cpu" and distributed.is_primary()
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "mp": 1}
    x = torch.arange(3.0)
    assert mesh.psum(x, "dp") is x and mesh.all_gather(x, "mp") is x


def test_distributed_init_env_driven_and_no_fallback(monkeypatch):
    monkeypatch.setenv("DLCO_COORDINATOR", "localhost:9")
    monkeypatch.setenv("DLCO_NUM_PROCESSES", "2")
    monkeypatch.setenv("DLCO_PROCESS_ID", "1")
    called = {}

    def fake_init(backend, init_method=None, world_size=None, rank=None,
                  timeout=None):
        called.update(backend=backend, init=init_method, n=world_size,
                      rank=rank)

    monkeypatch.setattr(distributed.dist, "init_process_group", fake_init)
    monkeypatch.setattr(distributed.dist, "get_world_size", lambda: 2)
    assert distributed.distributed_init(device="cpu") is True
    assert called == {"backend": "gloo", "init": "tcp://localhost:9",
                      "n": 2, "rank": 1}
    # the backend named is the one started, or the call raises
    monkeypatch.setattr(distributed.torch.cuda, "is_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="nccl needs CUDA"):
        distributed.distributed_init(backend="nccl", device="cpu")
    with pytest.raises(RuntimeError, match="nccl needs CUDA"):
        distributed.distributed_init(device="cuda")


def test_distributed_init_world_of_one_and_torchrun_detection(monkeypatch):
    """A world of one starts only when the caller names the backend and
    the coordinator; torchrun's WORLD_SIZE/RANK are read only with
    ``detect`` (the CLI's --distributed)."""
    for var in ("DLCO_COORDINATOR", "DLCO_NUM_PROCESSES", "DLCO_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    called = []

    def fake_init(backend, init_method=None, world_size=None, rank=None,
                  timeout=None):
        called.append(dict(backend=backend, init=init_method, n=world_size,
                           rank=rank))

    monkeypatch.setattr(distributed.dist, "init_process_group", fake_init)
    monkeypatch.setattr(distributed.dist, "get_world_size",
                        lambda: called[-1]["n"])
    assert distributed.distributed_init(num_processes=1, process_id=0,
                                        backend="gloo", device="cpu") is False
    assert distributed.distributed_init(
        coordinator="localhost:9", num_processes=1, process_id=0,
        device="cpu") is False
    assert not called
    assert distributed.distributed_init(
        coordinator="localhost:9", num_processes=1, process_id=0,
        backend="gloo", device="cpu") is False
    assert called == [dict(backend="gloo", init="tcp://localhost:9", n=1,
                           rank=0)]
    called.clear()
    for var, value in (("WORLD_SIZE", "2"), ("RANK", "1"),
                       ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "9")):
        monkeypatch.setenv(var, value)
    assert distributed.distributed_init(device="cpu") is False
    assert not called
    assert distributed.distributed_init(device="cpu", detect=True) is True
    assert called == [dict(backend="gloo", init="tcp://localhost:9", n=2,
                           rank=1)]


def test_ring_distances_sharded_matches_jax(world_run, inputs, jmesh):
    inp = inputs[0]
    ref = jsh.ring_distances_sharded(jmesh, jnp.asarray(inp["filters"]),
                                     jnp.asarray(inp["pt1"]),
                                     jnp.asarray(inp["pt2"]))
    world = world_run.ranks()
    np.testing.assert_allclose(_assemble(world, "ring"), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_pr_stats_sharded_matches_jax(world_run, inputs, jmesh):
    inp = inputs[0]
    ref = jsh.pr_stats_sharded(
        jmesh, jsh.shard_distance_matrix(jnp.asarray(inp["st_dists"]),
                                         jmesh),
        jax.device_put(jnp.asarray(inp["st_labels"]),
                       NamedSharding(jmesh, P("dp"))),
        jnp.asarray(inp["st_w"]))
    world = world_run.ranks()
    got = _same_on_every_rank(world, "stats")
    np.testing.assert_allclose(got, np.stack([np.asarray(x) for x in ref]),
                               rtol=1e-6, atol=1e-7)


def test_dry_run_on_four_ranks(world_run):
    world = world_run.ranks()
    runs = [json.loads(str(r["dryrun"])) for r in world]
    assert all(r == runs[0] for r in runs)
    s = runs[0]
    assert s["mesh"] == {"dp": 2, "mp": 2}
    assert s["pr_t"] == 4 * 2 and s["pj_t"] == 1
    assert s["pr_on_stage3_t"] == 2 * 2 * 2 and s["stage3"] == [32, 36]
    assert all(np.isfinite([s["obj"], s["pg_cost"], s["mvba_cost"]]))
    assert 0.0 <= s["stats_fpr95"] <= 1.0
