"""Two-view SfM's RANSAC and pose (pipeline/sfm.py over geometry/) held
against the JAX package on keys 0-5, on the matches the port's
two_view_sfm feeds RANSAC on test_torch_sfm.py's scene and header.

test_torch_sfm.py holds the whole pipeline under one key, PRNGKey(1). The
8-point solves of this scene are below f32 resolution (the f32 floor test
below), so under other keys the two packages' f32 RANSAC may pick
different winners. Here the comparison is made where it resolves:

- In f64, given JAX's own draws, both packages score every well-posed
  hypothesis with the same inlier mask, refit the best well-posed
  sample's inliers to the same E and Sampson mask, and RANSAC picks the
  same E and mask where both winners are well-posed; where a winner is
  not, each package returns at least its own best count. Well-posed: the
  sample's 8 x 9 design matrix has an eigen-gap (least over largest
  eigenvalue of A A^T) above f64 epsilon; these samples' gaps are
  >= 2.5e-10. About a third of the samples draw a row twice (rows are
  drawn with replacement); their gap is ~1e-33 and their E is an
  arbitrary vector of a 2-D null space in either package.
- From each key's f32 JAX winner (E, mask), the port's recover_pose in
  f32, and recover_pose + two-view BA + rms in f64, agree with JAX's. The
  f32 BA is not compared here: its LM steps amplify f32 rounding along
  the translation direction (t differs by up to ~2e-3 between the packages
  on these winners, ~1e-12 in f64); test_torch_sfm.py holds it under
  PRNGKey(1).

Tolerances: inlier counts and masks equal; R and t within 1e-4 (f32);
R, t and rms within 1e-9 and E within 1e-9 up to sign (f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_dlco_tpu.geometry.ba import (
    reprojection_residuals as jax_residuals, two_view_ba as jax_ba)
from opencv_dlco_tpu.geometry.epipolar import (
    eight_point as jax_eight_point, ransac_essential as jax_ransac,
    recover_pose as jax_recover_pose, sampson_distance as jax_sampson)

from opencv_dlco_tpu_torch.geometry.ba import (
    reprojection_residuals, two_view_ba)
from opencv_dlco_tpu_torch.geometry.epipolar import (
    eight_point, ransac_essential, recover_pose, sampson_distance)
from opencv_dlco_tpu_torch.models.vgg import VGGDescriptor
from opencv_dlco_tpu_torch.pipeline import sfm

from test_torch_sfm import C, F, KW, JaxDraws, header, scene  # noqa: F401

THRESH = 1e-5   # two_view_sfm's ransac_thresh default
KEYS = range(6)


@pytest.fixture(scope="module")
def matches(scene, header):
    """The normalized coordinates (x1, x2) two_view_sfm hands RANSAC."""
    img1, img2, _, _ = scene
    seen = {}
    inner = sfm.ransac_essential

    def record(x1, x2, idx, **kw):
        seen["x"] = (x1.numpy(), x2.numpy())
        return inner(x1, x2, idx, **kw)

    sfm.ransac_essential = record
    try:
        sfm.two_view_sfm(img1, img2, (F, F, C, C),
                         VGGDescriptor.from_header(header, device="cpu"),
                         draws=JaxDraws(jax.random.PRNGKey(1)), **KW)
    finally:
        sfm.ransac_essential = inner
    return seen["x"]


def test_eight_point_on_this_scene_is_below_f32_resolution(matches):
    """Why test_torch_sfm.py's parity key is chosen: on this scene's
    matches, every well-posed sample's eigen-gap is within 100 f32 epsilons
    (about half are below one), and the JAX package's f32 E lies ~1e-2 or
    more from the f64 solution of the same sample (PRNGKey(0)'s 128
    hypotheses, rank-deficient samples left out)."""
    x1, x2 = matches
    idx = JaxDraws(jax.random.PRNGKey(0)).ransac_idx(x1.shape[0], 128,
                                                     8).numpy()
    a1, a2 = x1[idx], x2[idx]                            # (128, 8, 2)
    e_jax = np.asarray(jax.vmap(jax_eight_point)(jnp.asarray(a1),
                                                 jnp.asarray(a2)))
    e_64 = eight_point(torch.from_numpy(a1).double(),
                       torch.from_numpy(a2).double()).numpy()

    def unit(e):
        e = e.reshape(len(e), 9)
        return e / np.linalg.norm(e, axis=1, keepdims=True)

    uj, u64 = unit(e_jax), unit(e_64)
    dev = np.minimum(np.abs(uj - u64).max(1), np.abs(uj + u64).max(1))
    gap = _design_gap(a1, a2)
    posed = gap > np.finfo(np.float64).eps
    eps32 = np.finfo(np.float32).eps
    assert posed.sum() >= 64
    assert gap[posed].max() < 100 * eps32, gap[posed].max() / eps32
    assert np.median(dev[posed]) > 1e-2, np.median(dev[posed])


def _design_gap(a1, a2):
    """Eigen-gap of each sample's 8 x 9 design matrix A, in f64: the least
    over the largest eigenvalue of A A^T (0 when the rows lose rank)."""
    h1, h2 = (np.concatenate([a, np.ones_like(a[..., :1])], -1).astype(
        np.float64) for a in (a1, a2))
    design = (h2[..., :, None] * h1[..., None, :]).reshape(len(a1), 8, 9)
    s = np.linalg.svd(design, compute_uv=False)
    return (s[:, -1] / s[:, 0]) ** 2


def _unit_sign(e):
    e = np.asarray(e, np.float64).reshape(9)
    e = e / np.linalg.norm(e)
    return e * np.sign(e[np.argmax(np.abs(e))])


@pytest.mark.parametrize("k", KEYS)
def test_ransac_matches_jax_in_f64(matches, k):
    """On the recorded matches in f64, with JAX's own draws of key k: every
    well-posed hypothesis scores the same inliers in both packages, the
    refit on the best well-posed sample's inliers gives the same E and
    Sampson mask, and RANSAC (winner, refit) returns the same E, mask and
    count where both winners are well-posed (see the module docstring)."""
    x1, x2 = matches
    t1, t2 = (torch.from_numpy(x.astype(np.float64)) for x in (x1, x2))
    with jax.enable_x64():
        j1, j2 = jnp.asarray(t1.numpy()), jnp.asarray(t2.numpy())
        key = jax.random.PRNGKey(k)
        idx = JaxDraws(key).ransac_idx(len(x1), KW["ransac_iters"], 8)
        ni = jnp.asarray(idx.numpy())
        e_all = jax.vmap(jax_eight_point)(j1[ni], j2[ni])
        inl_jax = np.asarray(jax_sampson(e_all, j1[None], j2[None]) < THRESH)
        e_jax, m_jax, n_jax = (np.asarray(v) for v in jax_ransac(
            j1, j2, key, n_hypotheses=KW["ransac_iters"], thresh=THRESH))
    i64 = idx.long()
    inl = (sampson_distance(eight_point(t1[i64], t2[i64]), t1[None],
                            t2[None]) < THRESH).numpy()
    count, count_jax = inl.sum(1), inl_jax.sum(1)
    gap = _design_gap(x1[i64.numpy()], x2[i64.numpy()])
    posed = gap > np.finfo(np.float64).eps
    assert posed.sum() >= KW["ransac_iters"] // 2
    assert (gap[~posed] < 1e-30).all() and (gap[posed] > 1e-12).all()
    np.testing.assert_array_equal(inl[posed], inl_jax[posed])
    # the refit on the best well-posed sample's inliers, in both packages
    best = np.flatnonzero(posed)[count[posed].argmax()]
    w = inl[best].astype(np.float64)
    e_fit = eight_point(t1, t2, weights=torch.from_numpy(w))
    with jax.enable_x64():
        e_fit_jax = jax_eight_point(j1, j2, weights=jnp.asarray(w))
        m_fit_jax = np.asarray(jax_sampson(e_fit_jax, j1, j2) < THRESH)
    m_fit = (sampson_distance(e_fit, t1, t2) < THRESH).numpy()
    np.testing.assert_array_equal(m_fit, m_fit_jax)
    np.testing.assert_allclose(_unit_sign(e_fit), _unit_sign(e_fit_jax),
                               atol=1e-9)
    e, m, n = ransac_essential(t1, t2, idx, thresh=THRESH)
    if not (posed[count.argmax()] and posed[count_jax.argmax()]):
        # A winner's sample lost rank: its E is an arbitrary null vector,
        # so its count, and which sample wins, follow each solver's
        # rounding (JAX's changes with XLA's Eigen threading). What both
        # packages define: the refit is kept only if it loses none of the
        # winner's inliers, so each returns at least its best count.
        assert int(n) == int(m.sum()) >= count.max()
        assert int(n_jax) == int(m_jax.sum()) >= count_jax.max()
        return
    assert int(n) == int(n_jax) >= 8
    np.testing.assert_array_equal(m.numpy(), m_jax)
    np.testing.assert_allclose(_unit_sign(e), _unit_sign(e_jax), atol=1e-9)


def _jax_pose(e, m, x1, x2):
    r, t, pts, _ = jax_recover_pose(e, x1, x2, m)
    ba = jax_ba(r, t, pts, x1, x2, weights=m.astype(x1.dtype),
                n_iters=12)
    res = np.asarray(jax_residuals(ba.r, ba.t, ba.points, x1, x2))[
        np.asarray(m)]
    return (np.asarray(r), np.asarray(t), np.asarray(ba.r),
            np.asarray(ba.t), float(np.sqrt((res ** 2).mean())))


def _pose(e, m, x1, x2):
    r, t, pts, _ = recover_pose(e, x1, x2, m)
    ba = two_view_ba(r, t, pts, x1, x2, weights=m.to(x1.dtype), n_iters=12)
    res = reprojection_residuals(ba.r, ba.t, ba.points, x1, x2)[m]
    return (r.numpy(), t.numpy(), ba.r.numpy(), ba.t.numpy(),
            float(torch.sqrt((res ** 2).mean())))


@pytest.mark.parametrize("k", KEYS)
def test_pose_from_jax_winner_matches_jax(matches, k):
    """JAX's RANSAC winner of key k (f32, as two_view_sfm runs it) fed to
    the port: recover_pose's R and t in f32, and recover_pose + two-view BA
    + rms in f64, equal JAX's on the same E and mask (the f32 BA is below
    f32 resolution along t, see the module docstring)."""
    x1, x2 = matches
    e, m, n = jax_ransac(jnp.asarray(x1), jnp.asarray(x2),
                         jax.random.PRNGKey(k),
                         n_hypotheses=KW["ransac_iters"], thresh=THRESH)
    assert int(n) >= 8
    r_ref, t_ref, _, _ = jax_recover_pose(e, jnp.asarray(x1),
                                          jnp.asarray(x2), m)
    te, tm = torch.from_numpy(np.array(e)), torch.from_numpy(np.array(m))
    r, t, _, _ = recover_pose(te, torch.from_numpy(x1),
                              torch.from_numpy(x2), tm)
    assert r.dtype == t.dtype == torch.float32
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=1e-4)
    with jax.enable_x64():
        ref = _jax_pose(jnp.asarray(np.array(e), jnp.float64),
                        jnp.asarray(np.array(m)),
                        jnp.asarray(x1.astype(np.float64)),
                        jnp.asarray(x2.astype(np.float64)))
    ours = _pose(te.double(), tm, torch.from_numpy(x1).double(),
                 torch.from_numpy(x2).double())
    for a, b in zip(ours[:4], ref[:4]):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_allclose(a, b, atol=1e-9)
    assert abs(ours[4] - ref[4]) <= 1e-9
