"""The port's two-view SfM (pipeline/sfm.py) and its ``sfm`` command, held
against the JAX package on the same inputs.

The scene is a 256 px version of tests/test_sfm.py's two-view blob field
(seed 2215, 220 points, rotation so3_exp([0.02, -0.03, 0.01]), t [0.3,
0.1, 0.02]); the descriptor is the test header of test_torch_slam.py (96
bank rows, a seeded 64-D projection), since no reference header ships with
the repo. Both packages take the same RANSAC sample table: JAX's
``jax.random.randint`` draws of one key, fed to the port through a draw
source. 256 keypoints, 128 hypotheses.

The key is PRNGKey(1). RANSAC here scores 8-point hypotheses whose f32
solve is below f32 resolution: the minimal samples' A^T A (normalized
coordinates, no Hartley scaling, as in the reference) has an eigenvalue gap
within a few f32 epsilons, so its null vector is rounding noise, and the JAX
package's E lies ~1e-2 or more from the f64 solution of the same sample
(test_torch_sfm_ransac.py shows it). Two LAPACK
builds then pick different winners under some keys (PRNGKey(0): 56 inliers
in JAX against 53 in the port, each package's winner scoring well in its
own f32 only). Under PRNGKey(1) both packages pick the same winner, and the
whole pose is held at 1e-4; test_torch_slam.py chooses its keys for the
same reason.

test_torch_sfm_ransac.py holds RANSAC and the pose on further keys, and
shows the f32 floor of the 8-point solve on this scene.

Tolerances: match and inlier counts equal; R, t and the rms reprojection
error within 1e-4.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from opencv_dlco_tpu.models.vgg import VGGDescriptor as JaxVGG
from opencv_dlco_tpu.pipeline.sfm import two_view_sfm as jax_sfm

from opencv_dlco_tpu_torch import cli
from opencv_dlco_tpu_torch.geometry.se3 import so3_exp
from opencv_dlco_tpu_torch.models.vgg import VGGDescriptor
from opencv_dlco_tpu_torch.ops.pool_regions import build_filter_bank
from opencv_dlco_tpu_torch.pipeline.export import emit_vgg_header
from opencv_dlco_tpu_torch.pipeline.sfm import two_view_sfm
from opencv_dlco_tpu_torch.utils.configs import PoolRegionConfig

F, C, SIZE = 300.0, 128.0, 256
KW = dict(n_keypoints=256, ransac_iters=128)


class JaxDraws:
    """RANSAC sample source replaying ransac_essential's
    ``jax.random.randint(key, (n_hyp, 8), 0, n)``."""

    def __init__(self, key):
        self.key = key

    def ransac_idx(self, hi, n_hyp, sample):
        return torch.from_numpy(np.array(jax.random.randint(
            self.key, (n_hyp, sample), 0, int(hi))))


def render_3d_blobs(pts3d, amps, sigma_px, f, c, size, r=None, t=None):
    """tests/test_sfm.py's splatter: Gaussian blobs at the projections."""
    if r is not None:
        pts3d = pts3d @ np.asarray(r).T + np.asarray(t)
    u = f * pts3d[:, 0] / pts3d[:, 2] + c
    v = f * pts3d[:, 1] / pts3d[:, 2] + c
    yy, xx = np.mgrid[:size, :size].astype(np.float64)
    img = np.zeros((size, size))
    for ui, vi, a, s in zip(u, v, amps, sigma_px):
        if -10 < ui < size + 10 and -10 < vi < size + 10:
            img += a * np.exp(-((yy - vi) ** 2 + (xx - ui) ** 2)
                              / (2 * s ** 2))
    img = (img - img.min()) / (img.max() - img.min() + 1e-12)
    return (img * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(2215)
    n = 220
    pts3d = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                      rng.uniform(4, 9, n)], 1)
    amps = rng.uniform(0.4, 1.0, n) * rng.choice([-1, 1], n)
    sigmas = rng.uniform(2.0, 4.0, n)
    r = so3_exp(torch.tensor([0.02, -0.03, 0.01])).numpy().astype(np.float64)
    t = np.array([0.3, 0.1, 0.02])
    img1 = render_3d_blobs(pts3d, amps, sigmas, F, C, SIZE)
    img2 = render_3d_blobs(pts3d, amps, sigmas, F, C, SIZE, r=r, t=t)
    return img1, img2, r, t


@pytest.fixture(scope="module")
def header():
    """test_torch_slam.py's header: 96 rows of the 16x2x4 ring bank and a
    seeded 64 x 768 projection."""
    rng = np.random.default_rng(31)
    _, _, bank = build_filter_bank(PoolRegionConfig(nr=16, nphi=2, nsigma=4))
    sel = bank[rng.choice(bank.shape[0], 96, replace=False)].astype(
        np.float32)
    pj = (rng.standard_normal((64, 768)) / np.sqrt(768)).astype(np.float32)
    return emit_vgg_header(sel, pj)


@pytest.fixture(scope="module")
def results(scene, header):
    """(port result, JAX result) under PRNGKey(1)'s draws."""
    img1, img2, _, _ = scene
    intr = (F, F, C, C)
    ours = two_view_sfm(img1, img2, intr,
                        VGGDescriptor.from_header(header, device="cpu"),
                        draws=JaxDraws(jax.random.PRNGKey(1)), **KW)
    ref = jax_sfm(img1, img2, intr, JaxVGG.from_header(header),
                  key=jax.random.PRNGKey(1), **KW)
    return ours, ref


def test_two_view_sfm_matches_jax(results):
    ours, ref = results
    assert ours.n_matches == ref.n_matches
    assert ours.n_inliers == ref.n_inliers
    np.testing.assert_allclose(ours.rotation, ref.rotation, atol=1e-4)
    np.testing.assert_allclose(ours.translation, ref.translation, atol=1e-4)
    assert abs(ours.rms_reproj - ref.rms_reproj) <= 1e-4
    np.testing.assert_array_equal(ours.keypoints1, ref.keypoints1)
    np.testing.assert_array_equal(ours.keypoints2, ref.keypoints2)
    assert ours.points3d.shape == ref.points3d.shape


def test_two_view_sfm_recovers_the_pose(results, scene):
    """Pose gates on the 256 px scene: enough inliers, rotation error under
    2 degrees, the translation direction within cos 0.9."""
    ours, _ = results
    _, _, r, t = scene
    assert ours.n_inliers >= 8 and np.isfinite(ours.rotation).all()
    dr = ours.rotation @ r.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1)))
    assert ang < 2.0, ang
    cos = abs(ours.translation @ t / (np.linalg.norm(ours.translation)
                                      * np.linalg.norm(t)))
    assert cos > 0.9, cos


def test_sfm_command_on_bmps(tmp_path, scene, header, capsys):
    """``sfm`` reads BMPs through native.load_gray and prints the JAX
    command's keys; with its default draws it runs the pipeline as
    two_view_sfm does."""
    import cv2

    img1, img2, _, _ = scene
    paths = []
    for i, img in enumerate((img1, img2)):
        p = str(tmp_path / f"view{i}.bmp")
        assert cv2.imwrite(p, img)
        paths.append(p)
    model = tmp_path / "vgg_generated_64.i"
    model.write_text(header)
    cli.main(["sfm", "--image1", paths[0], "--image2", paths[1],
              "--model", str(model), "--intrinsics", f"{F},{F},{C},{C}",
              "--keypoints", "256", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"n_matches", "n_inliers", "rms_reproj", "rotation",
                        "translation", "n_points"}
    direct = two_view_sfm(img1, img2, (F, F, C, C),
                          VGGDescriptor.from_header(header, device="cpu"),
                          n_keypoints=256)
    assert out["n_matches"] == direct.n_matches
    assert out["n_inliers"] == direct.n_inliers == out["n_points"]
    np.testing.assert_array_equal(np.asarray(out["rotation"]),
                                  direct.rotation.astype(np.float64))
