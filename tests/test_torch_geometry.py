"""The port's geometry stack held against the JAX package on the same numpy
inputs: SE(3)/Sim(3) maps, triangulation, the 8-point solver, Sampson
distances, RANSAC given JAX's own sample table, cheirality pose recovery,
two-view and multi-view BA, and the SE(3)/Sim(3) pose graphs.

Tolerances: 1e-5 relative unless stated (f32 on both sides); E up to sign
(eigenvector signs are the solver's choice); poses from recover_pose by
rotation angle (< 1e-3 rad) and translation direction (cosine > 0.9999);
BA, MVBA and pose-graph results at 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opencv_dlco_tpu import geometry as jg

from opencv_dlco_tpu_torch import geometry as tg

from test_geometry import _two_view_scene
from test_mvba import _mv_problem, _perturb


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, ref, rtol=1e-5, atol=1e-6):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def _angle(ra, rb):
    c = (np.trace(np.asarray(ra, np.float64) @ np.asarray(rb, np.float64).T)
         - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


# -- Lie groups -------------------------------------------------------------

def test_so3_se3_exp_log_match_jax_and_round_trip():
    rng = np.random.default_rng(0)
    phi = rng.normal(size=(12, 3))
    phi *= (rng.uniform(0.0, 3.1, 12) / np.linalg.norm(phi, axis=1))[:, None]
    phi[0] = 0.0                        # identity: the small-angle branch
    phi[1] *= 1e-5
    phi = phi.astype(np.float32)
    r = tg.so3_exp(_t(phi))
    _close(r, jg.so3_exp(jnp.asarray(phi)), atol=2e-6)
    rr = r.numpy()
    assert np.allclose(rr @ rr.transpose(0, 2, 1), np.eye(3), atol=1e-5)
    _close(tg.so3_log(r), jg.so3_log(jnp.asarray(rr)), atol=3e-5)
    _close(tg.so3_log(r)[:11], phi[:11], atol=3e-5)   # round trip below pi
    xi = np.concatenate([rng.normal(size=(12, 3)), phi], 1).astype(np.float32)
    r6, t6 = tg.se3_exp(_t(xi))
    rj, tj = jg.se3_exp(jnp.asarray(xi))
    _close(r6, rj, atol=2e-6)
    _close(t6, tj, atol=5e-6)
    _close(tg.se3_log(r6, t6), jg.se3_log(rj, tj), rtol=1e-4, atol=1e-4)
    _close(tg.se3_log(r6, t6)[:8], xi[:8], rtol=1e-4, atol=1e-4)
    assert torch.equal(tg.vee(tg.hat(_t(phi))), _t(phi))


def test_se3_and_sim3_group_ops_match_jax():
    rng = np.random.default_rng(1)
    xa = (rng.normal(size=(5, 6)) * 0.5).astype(np.float32)
    xb = (rng.normal(size=(5, 6)) * 0.5).astype(np.float32)
    ra, ta = (x.numpy() for x in tg.se3_exp(_t(xa)))
    rb, tb = (x.numpy() for x in tg.se3_exp(_t(xb)))
    sa = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    sb = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    ours = tg.se3_compose(_t(ra), _t(ta), _t(rb), _t(tb))
    ref = jg.se3_compose(*(jnp.asarray(v) for v in (ra, ta, rb, tb)))
    for a, b in zip(ours, ref):
        _close(a, b)
    for a, b in zip(tg.se3_inverse(_t(ra), _t(ta)),
                    jg.se3_inverse(jnp.asarray(ra), jnp.asarray(ta))):
        _close(a, b)
    x = rng.normal(size=(5, 7, 3)).astype(np.float32)
    _close(tg.se3_apply(_t(ra), _t(ta), _t(x)),
           jg.se3_apply(jnp.asarray(ra), jnp.asarray(ta), jnp.asarray(x)),
           atol=1e-5)
    ours = tg.sim3_compose(_t(ra), _t(ta), _t(sa), _t(rb), _t(tb), _t(sb))
    ref = jg.sim3_compose(*(jnp.asarray(v) for v in (ra, ta, sa, rb, tb, sb)))
    for a, b in zip(ours, ref):
        _close(a, b, atol=1e-5)
    inv = tg.sim3_inverse(_t(ra), _t(ta), _t(sa))
    for a, b in zip(inv, jg.sim3_inverse(jnp.asarray(ra), jnp.asarray(ta),
                                         jnp.asarray(sa))):
        _close(a, b)
    # x o x^-1 = identity
    r_id, t_id, s_id = tg.sim3_compose(_t(ra), _t(ta), _t(sa), *inv)
    _close(r_id, np.broadcast_to(np.eye(3), (5, 3, 3)), atol=1e-5)
    _close(t_id, np.zeros((5, 3)), atol=1e-5)
    _close(s_id, np.ones(5))
    x7 = np.concatenate([xa, sa[:, None] - 1.0], 1)
    for a, b in zip(tg.sim3_exp(_t(x7)), jg.sim3_exp(jnp.asarray(x7))):
        _close(a, b, atol=5e-6)


# -- two-view geometry ------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    return _two_view_scene(np.random.default_rng(5), n=160, noise=2e-4,
                           outlier_frac=0.2)


def test_triangulate_points_matches_jax(scene):
    # 1e-4: the normal equations of a point at depth ~10 over a 0.5
    # baseline have a condition number ~1e5, so one f32 rounding of A^T A
    # in another summation order (or LAPACK build) moves the solution by up
    # to ~1e-4 relative on both sides alike
    pts, r, t, p1, p2 = scene
    ours = tg.triangulate_points(_t(r), _t(t), _t(p1), _t(p2))
    ref = jg.triangulate_points(jnp.asarray(r, jnp.float32),
                                jnp.asarray(t, jnp.float32),
                                jnp.asarray(p1), jnp.asarray(p2))
    _close(ours[32:], ref[32:], rtol=1e-4, atol=1e-4)   # the inlier rows
    _close(ours, ref, rtol=1e-3, atol=1e-3)
    # batched over a leading axis: the same points per problem
    batched = tg.triangulate_points(_t(np.stack([r, r])), _t(np.stack([t, t])),
                                    _t(np.stack([p1, p1])),
                                    _t(np.stack([p2, p2])))
    _close(batched[1], ours, rtol=1e-5, atol=1e-5)


def _null_vector_bound(x1, x2, w=None):
    """First-order f32 error of the smallest eigenvector of A^T A:
    eps_f32 * |A^T A| / (gap to the next eigenvalue), from float64."""
    a = np.concatenate([x2, np.ones((len(x2), 1))], 1)[:, :, None] \
        * np.concatenate([x1, np.ones((len(x1), 1))], 1)[:, None, :]
    a = a.reshape(len(x1), 9).astype(np.float64)
    if w is not None:
        a = a * w[:, None]
    ev = np.linalg.eigvalsh(a.T @ a)
    return np.finfo(np.float32).eps * ev[-1] / (ev[1] - ev[0])


def test_eight_point_and_sampson_match_jax(scene):
    _, _, _, p1, p2 = scene
    n_in = 128                          # the inlier rows
    x1, x2 = p1[-n_in:], p2[-n_in:]
    w = (np.random.default_rng(2).random(n_in) < 0.8).astype(np.float32)
    for weights in (None, w):
        ours = tg.eight_point(_t(x1), _t(x2), None if weights is None
                              else _t(weights)).numpy()
        ref = np.asarray(jg.eight_point(jnp.asarray(x1), jnp.asarray(x2),
                                        None if weights is None
                                        else jnp.asarray(weights)))
        # E up to sign, within the f32 conditioning of its null vector
        # (the eigenvalue gap of A^T A is ~1e-5 of its norm here, so
        # either side's f32 eigensolver is only that exact)
        sign = np.sign(np.sum(ours * ref))
        np.testing.assert_allclose(sign * ours, ref,
                                   atol=_null_vector_bound(x1, x2, weights))
        # the same math exactly: float64 against numpy's null vector
        x64 = [torch.from_numpy(v.astype(np.float64)) for v in (x1, x2)]
        e64 = tg.eight_point(*x64, None if weights is None else
                             torch.from_numpy(weights.astype(np.float64)))
        a = tg.epipolar._design_matrix(*x64).numpy()
        if weights is not None:
            a = a * weights[:, None]
        v = np.linalg.eigh(a.T @ a)[1][:, 0].reshape(3, 3)
        u, sv, vt = np.linalg.svd(v)
        e_np = u @ np.diag([(sv[0] + sv[1]) / 2] * 2 + [0.0]) @ vt
        e64 = e64.numpy()
        np.testing.assert_allclose(np.sign(np.sum(e64 * e_np)) * e64, e_np,
                                   atol=1e-10)
        # Sampson distances of one E: 1e-5 relative
        d = tg.sampson_distance(_t(ref), _t(p1), _t(p2))
        _close(d, jg.sampson_distance(jnp.asarray(ref), jnp.asarray(p1),
                                      jnp.asarray(p2)), rtol=1e-5, atol=1e-12)
    e = np.stack([ref, -ref]).astype(np.float32)
    _close(tg.essential_project(_t(e)),
           jg.essential_project(jnp.asarray(e)), atol=2e-6)
    xn, tn = tg.normalize_points(_t(p1))
    xn_j, tn_j = jg.normalize_points(jnp.asarray(p1))
    _close(xn, xn_j, atol=1e-5)
    _close(tn, tn_j, atol=1e-5)


def _jax_ransac_table(key, n, n_valid, n_hyp):
    """The (H, 8) sample table jax ransac_essential draws from ``key``
    (geometry/epipolar.py:114-115)."""
    hi = jnp.clip(jnp.int32(n_valid), 8, n)
    return np.asarray(jax.random.randint(key, (n_hyp, 8), 0, hi))


@pytest.mark.parametrize("n_valid", [None, 120])
def test_ransac_essential_matches_jax_given_its_draws(n_valid):
    # small pixel noise: inlier distances sit far below the threshold and
    # outliers far above, as in the SLAM scenes
    _, _, _, p1, p2 = _two_view_scene(np.random.default_rng(5), n=160,
                                      noise=2e-5, outlier_frac=0.2)
    n, thresh, n_hyp = p1.shape[0], 4e-6, 256
    key = jax.random.PRNGKey(7)
    e_j, m_j, n_j = jg.ransac_essential(
        jnp.asarray(p1), jnp.asarray(p2), key, n_hypotheses=n_hyp,
        thresh=thresh,
        n_valid=None if n_valid is None else jnp.int32(n_valid))
    idx = _jax_ransac_table(key, n, n if n_valid is None else n_valid, n_hyp)
    e, m, cnt = tg.ransac_essential(
        _t(p1), _t(p2), torch.from_numpy(idx), thresh=thresh,
        n_valid=None if n_valid is None else torch.tensor(n_valid))
    m_j = np.asarray(m_j)
    # the same inliers, except correspondences within 1e-6 (relative) of
    # the threshold under the JAX model
    d_j = np.asarray(jg.sampson_distance(e_j, jnp.asarray(p1),
                                         jnp.asarray(p2)))
    differ = m.numpy() != m_j
    assert np.all(np.abs(d_j[differ] - thresh) <= 1e-6 * thresh + 1e-12)
    assert int(cnt) == int(m.numpy().sum())
    # every valid inlier (the 32 outliers lead the rows), give or take two
    assert int(cnt) >= (n if n_valid is None else n_valid) - 32 - 2
    if n_valid is not None:
        assert not m.numpy()[n_valid:].any()
    e, e_j = e.numpy(), np.asarray(e_j)
    inl = m.numpy()
    np.testing.assert_allclose(np.sign(np.sum(e * e_j)) * e, e_j,
                               atol=_null_vector_bound(p1[inl], p2[inl]))


def test_recover_pose_matches_jax(scene):
    pts, r, t, p1, p2 = scene
    x1, x2 = p1[32:], p2[32:]           # the inlier rows
    e = np.asarray(jg.eight_point(jnp.asarray(x1), jnp.asarray(x2)))
    r_j, t_j, pts_j, n_j = jg.recover_pose(jnp.asarray(e), jnp.asarray(x1),
                                           jnp.asarray(x2))
    for sign in (1.0, -1.0):            # E and -E give the same pose
        r_o, t_o, pts_o, n_o = tg.recover_pose(_t(sign * e), _t(x1), _t(x2))
        assert _angle(r_o.numpy(), r_j) < 1e-3
        assert float(t_o.numpy() @ np.asarray(t_j)) > 0.9999
        assert int(n_o) == int(n_j)
        _close(pts_o, pts_j, rtol=1e-4, atol=1e-4)
    assert _angle(r_o.numpy(), r) < 1e-2     # and it is the true pose
    mask = np.zeros(len(x1), bool)
    mask[::2] = True
    _, _, _, n_m = tg.recover_pose(_t(e), _t(x1), _t(x2), torch.from_numpy(mask))
    assert int(n_m) == int(jg.recover_pose(jnp.asarray(e), jnp.asarray(x1),
                                           jnp.asarray(x2),
                                           jnp.asarray(mask))[3])


# -- bundle adjustment ------------------------------------------------------

@pytest.mark.parametrize("robust_delta", [0.0, 0.005])
def test_two_view_ba_matches_jax(robust_delta):
    rng = np.random.default_rng(3)
    pts, r, t, p1, p2 = _two_view_scene(rng, n=96, noise=1e-4)
    if robust_delta:
        p2 = p2.copy()
        p2[:8] += 0.2
    r0 = (jg.so3_exp(jnp.asarray([0.01, -0.02, 0.005])) @ r).astype(
        jnp.float32)
    t0 = (t + 0.03).astype(np.float32)
    pts0 = (pts * (1 + rng.normal(0, 0.02, pts.shape))).astype(np.float32)
    w = (rng.random(96) < 0.9).astype(np.float32)
    ref = jg.two_view_ba(jnp.asarray(r0), jnp.asarray(t0), jnp.asarray(pts0),
                         jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w),
                         n_iters=6, robust_delta=robust_delta)
    ours = tg.two_view_ba(_t(r0), _t(t0), _t(pts0), _t(p1), _t(p2), _t(w),
                          n_iters=6, robust_delta=robust_delta)
    for a, b in zip(ours, ref):
        _close(a, b, rtol=1e-4, atol=1e-4)
    # batched over a leading axis: each problem as on its own
    both = tg.two_view_ba(*(torch.stack([_t(v), _t(v)])
                            for v in (r0, t0, pts0, p1, p2, w)), n_iters=6,
                          robust_delta=robust_delta)
    for a, b in zip(both, ours):
        _close(a[1], b, rtol=1e-5, atol=1e-5)
    _close(tg.reprojection_residuals(ours.r, ours.t, ours.points, _t(p1),
                                     _t(p2)),
           jg.reprojection_residuals(ref.r, ref.t, ref.points,
                                     jnp.asarray(p1), jnp.asarray(p2)),
           rtol=1e-4, atol=1e-5)


def test_multi_view_ba_matches_jax():
    rng = np.random.default_rng(11)
    pts, rs, ts, cam_idx, pt_idx, uv = _mv_problem(rng, m=4, n=60)
    rs_p, ts_p, pts_p = _perturb(rng, rs, ts, pts)
    table, _ = tg.build_landmark_table(pt_idx, pts.shape[0])
    table_j, _ = jg.build_landmark_table(pt_idx, pts.shape[0])
    np.testing.assert_array_equal(table, table_j)
    w = (rng.random(uv.shape[0]) < 0.95).astype(np.float32)
    ref = jg.multi_view_ba(*(jnp.asarray(v) for v in (
        rs_p.astype(np.float32), ts_p.astype(np.float32),
        pts_p.astype(np.float32), cam_idx, pt_idx, uv, table, w)), n_iters=5)
    ours = tg.multi_view_ba(_t(rs_p), _t(ts_p), _t(pts_p),
                            torch.from_numpy(cam_idx), torch.from_numpy(pt_idx),
                            _t(uv), table, _t(w), n_iters=5)
    costs = ours.cost_history.numpy()
    assert costs[-1] < costs[0] * 0.1
    for a, b in zip(ours, ref):
        _close(a, b, rtol=1e-4, atol=1e-4)


# -- pose graphs ------------------------------------------------------------

def _loop_scene():
    """tests/test_geometry.py:188's scene: a noisy odometry circle of 20
    poses and one exact closure last -> first."""
    rng = np.random.default_rng(7)
    m = 20
    rs, ts = [np.eye(3)], [np.zeros(3)]
    step_xi = np.array([0.5, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / m])
    for _ in range(1, m):
        dr, dt = jg.se3_exp(jnp.asarray(step_xi))
        r, t = jg.se3_compose(jnp.asarray(rs[-1]), jnp.asarray(ts[-1]), dr, dt)
        rs.append(np.asarray(r))
        ts.append(np.asarray(t))
    ei, ej, rz, tz = [], [], [], []
    rs0, ts0 = [rs[0]], [ts[0]]
    for i in range(m - 1):
        r_rel, t_rel = jg.se3_compose(
            *jg.se3_inverse(jnp.asarray(rs[i]), jnp.asarray(ts[i])),
            jnp.asarray(rs[i + 1]), jnp.asarray(ts[i + 1]))
        noise = jg.se3_exp(jnp.asarray(rng.normal(size=6) * 0.01))
        r_n, t_n = jg.se3_compose(r_rel, t_rel, *noise)
        ei.append(i)
        ej.append(i + 1)
        rz.append(np.asarray(r_n))
        tz.append(np.asarray(t_n))
        r0, t0 = jg.se3_compose(jnp.asarray(rs0[-1]), jnp.asarray(ts0[-1]),
                                r_n, t_n)
        rs0.append(np.asarray(r0))
        ts0.append(np.asarray(t0))
    r_rel, t_rel = jg.se3_compose(
        *jg.se3_inverse(jnp.asarray(rs[m - 1]), jnp.asarray(ts[m - 1])),
        jnp.asarray(rs[0]), jnp.asarray(ts[0]))
    ei.append(m - 1)
    ej.append(0)
    rz.append(np.asarray(r_rel))
    tz.append(np.asarray(t_rel))
    return (np.stack(rs0).astype(np.float32), np.stack(ts0).astype(np.float32),
            np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.stack(rz).astype(np.float32), np.stack(tz).astype(np.float32))


def _drift_scene():
    """tests/test_geometry.py:261's scene: 24 poses on a circle, 6% scale
    drift per odometry edge, four exact closures."""
    m = 24
    rs, ts = [], []
    for k in range(m):
        th = 2 * np.pi * k / m
        rs.append(np.asarray(jg.so3_exp(jnp.asarray(
            [0.0, 0.1 * np.sin(th), 0.0]))))
        ts.append(np.array([np.cos(th) - 1.0, np.sin(th),
                            0.05 * np.sin(th)]))
    ei, ej, rz, tz = [], [], [], []
    drift = 1.0
    dr_, dt_ = [rs[0]], [ts[0]]
    for k in range(m - 1):
        r_rel, t_rel = jg.se3_compose(
            *jg.se3_inverse(jnp.asarray(rs[k]), jnp.asarray(ts[k])),
            jnp.asarray(rs[k + 1]), jnp.asarray(ts[k + 1]))
        drift *= 1.06
        ei.append(k)
        ej.append(k + 1)
        rz.append(np.asarray(r_rel))
        tz.append(np.asarray(t_rel) * drift)
        r_w, t_w = jg.se3_compose(jnp.asarray(dr_[-1]), jnp.asarray(dt_[-1]),
                                  jnp.asarray(rz[-1]), jnp.asarray(tz[-1]))
        dr_.append(np.asarray(r_w))
        dt_.append(np.asarray(t_w))
    for a, b in [(0, m - 1), (0, 12), (6, 18), (3, 21)]:
        r_l, t_l = jg.se3_compose(
            *jg.se3_inverse(jnp.asarray(rs[a]), jnp.asarray(ts[a])),
            jnp.asarray(rs[b]), jnp.asarray(ts[b]))
        ei.append(a)
        ej.append(b)
        rz.append(np.asarray(r_l))
        tz.append(np.asarray(t_l))
    return (np.stack(dr_).astype(np.float32), np.stack(dt_).astype(np.float32),
            np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.stack(rz).astype(np.float32), np.stack(tz).astype(np.float32))


@pytest.mark.parametrize("robust", ["none", "huber", "dcs"])
def test_optimize_pose_graph_matches_jax(robust):
    args = _loop_scene()
    w = np.ones(args[2].shape[0], np.float32)
    w[-1] = 2.0
    kw = dict(n_iters=12)
    if robust != "none":
        kw.update(robust=robust, robust_delta=0.05, gnc_iters=3)
    ref = jg.optimize_pose_graph(*(jnp.asarray(a) for a in args),
                                 jnp.asarray(w), **kw)
    ours = tg.optimize_pose_graph(*(torch.from_numpy(a) for a in args),
                                  _t(w), **kw)
    for a, b in zip(ours, ref):
        _close(a, b, rtol=1e-4, atol=1e-4)
    costs = ours.cost_history.numpy()
    assert costs[-1] < costs[0] * (0.1 if robust == "none" else 0.5)


@pytest.mark.parametrize("robust, dtype", [("none", np.float64),
                                           ("dcs", np.float32)],
                         ids=["none", "dcs"])
def test_optimize_pose_graph_sim3_matches_jax(robust, dtype):
    """The Sim(3) pose graph against JAX on the drift scene. Without a
    robust kernel the f32 solve is ill-conditioned in scale: its R, t and s
    follow the last bits of torch's f32 reductions, whose order changes
    with the thread count (1.3e-4 apart at 1 and 8 threads), so that case
    is compared in float64 on both sides, where the packages agree to
    ~1e-15 at any thread count. The f32 path is held by the dcs case."""
    args = [a.astype(dtype) if a.dtype == np.float32 else a
            for a in _drift_scene()]
    e = args[2].shape[0]
    s_z = np.ones(e, dtype)
    s_z[-4:] = [1.1, 0.9, 1.05, 1.0]
    kw = dict(n_iters=10)
    if robust != "none":
        kw.update(robust=robust, robust_delta=0.0, gnc_iters=4)
    with jax.enable_x64(dtype == np.float64):
        ref = jg.optimize_pose_graph_sim3(*(jnp.asarray(a) for a in args),
                                          None, jnp.asarray(s_z), **kw)
    ours = tg.optimize_pose_graph_sim3(*(torch.from_numpy(a) for a in args),
                                       None, torch.from_numpy(s_z), **kw)
    assert ours[0].numpy().dtype == np.asarray(ref[0]).dtype == dtype
    if dtype == np.float64:
        for a, b in zip(ours[:3], ref[:3]):
            _close(a, b, rtol=1e-9, atol=1e-9)
        _close(ours.cost_history, ref.cost_history, rtol=1e-9)
    else:
        for a, b in zip(ours[:3], ref[:3]):
            _close(a, b, rtol=1e-4, atol=1e-4)
        # the cost history: its end at 1e-4; the first LM steps, far from
        # the optimum, carry f32 rounding of the large early residuals
        _close(ours.cost_history[-1], ref.cost_history[-1], rtol=1e-4)
        _close(ours.cost_history, ref.cost_history, rtol=1e-3)
    assert abs(float(ours.s[0]) - 1.0) < 1e-3        # gauge


# -- deterministic segment sums ---------------------------------------------

@pytest.mark.parametrize("case", ["duplicates", "empty_segments", "empty"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segment_sum_matches_index_add_and_jax(case, dtype):
    """The solvers' deterministic segment sum against torch's index_add and
    JAX's .at[].add on the same (K, 3, 2) values: duplicate indices, empty
    segments, an empty input; 1e-6 of each segment's absolute sum (three
    summation orders of the same values). The table lists each segment's
    positions in input order and drops indices outside [0, n)."""
    from opencv_dlco_tpu_torch.geometry.segment import (segment_sum,
                                                        segment_table)

    rng = np.random.default_rng(7)
    n = 9
    idx = {"duplicates": rng.integers(0, n, 200),
           "empty_segments": rng.choice([0, 3, 4, 8], 57),
           "empty": np.zeros(0, np.int64)}[case]
    vals = rng.normal(size=(idx.size, 3, 2)).astype(dtype)
    table = segment_table(torch.from_numpy(idx), n)
    got = segment_sum(torch.from_numpy(vals), table).numpy()
    assert got.shape == (n, 3, 2) and got.dtype == dtype
    ref_t = torch.zeros((n, 3, 2), dtype=torch.from_numpy(vals).dtype) \
        .index_add(0, torch.from_numpy(idx), torch.from_numpy(vals)).numpy()
    with jax.enable_x64(dtype == np.float64):
        ref_j = np.asarray(jnp.zeros((n, 3, 2), dtype).at[idx].add(vals))
    mag = np.zeros((n, 3, 2))
    np.add.at(mag, idx, np.abs(vals.astype(np.float64)))
    for ref in (ref_t, ref_j):
        assert np.all(np.abs(got - ref) <= 1e-6 * mag)
    for s in range(n):
        row = table[s].numpy()
        listed = row[row < idx.size]
        np.testing.assert_array_equal(listed, np.nonzero(idx == s)[0])
        assert np.all(row[listed.size:] == idx.size)
    drop = segment_table(torch.tensor([2, -1, 2, n, 0]), n)
    assert drop[2].tolist()[:2] == [0, 2] and drop[0].tolist()[0] == 4
    assert int((drop < 5).sum()) == 3
