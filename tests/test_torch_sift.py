"""The port's SIFT baseline (ops/sift.py) held against the JAX package:
the same 64 patches through both, abs 1e-5 (f32 products with TF32 off
against Precision.HIGHEST), the operators themselves equal, and the
invariants of tests/test_sift.py (unit norm, clipping, determinism,
brightness invariance, verification quality)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opencv_dlco_tpu.ops import sift as jax_sift

from opencv_dlco_tpu_torch.data.synthetic import synth_patch_pairs
from opencv_dlco_tpu_torch.ops import sift
from opencv_dlco_tpu_torch.ops.sift import N_DIM, sift_describe
from opencv_dlco_tpu_torch.pipeline.eval import verification


def _describe(p):
    return sift_describe(p, device="cpu").numpy()


def test_operators_equal_jax():
    for size in (32, 64):
        np.testing.assert_array_equal(sift._spatial_weights(size),
                                      jax_sift._spatial_weights(size))
        np.testing.assert_array_equal(sift._gauss_window(size),
                                      jax_sift._gauss_window(size))


@pytest.mark.parametrize("source", ["uniform", "textured"])
def test_sift_describe_matches_jax(source):
    if source == "uniform":
        patches = np.random.default_rng(0).integers(
            0, 256, (64, 64, 64)).astype(np.uint8)
    else:
        p1, p2, _ = synth_patch_pairs(np.random.default_rng(11), n_pairs=32,
                                      shift=4, noise=0.12)
        patches = np.concatenate([p1, p2])
    ours = _describe(patches)
    ref = np.asarray(jax_sift.sift_describe(jnp.asarray(patches)))
    assert ours.shape == ref.shape == (64, N_DIM)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_sift_fn_at_another_patch_size_matches_jax():
    patches = np.random.default_rng(1).integers(
        0, 256, (8, 32, 32)).astype(np.float32)
    ours = sift.sift_fn(32, sigma=1.0, clip=0.3, device="cpu")(
        torch.from_numpy(patches)).numpy()
    ref = np.asarray(jax_sift.sift_fn(32, sigma=1.0, clip=0.3)(
        jnp.asarray(patches)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_sift_descriptor_invariants():
    patches = np.random.default_rng(2).integers(
        0, 255, (16, 64, 64)).astype(np.uint8)
    d = _describe(patches)
    assert d.shape == (16, N_DIM) and d.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    assert d.min() >= 0.0 and d.max() <= 0.35
    np.testing.assert_array_equal(d, _describe(torch.from_numpy(patches)))
    assert _describe(patches[:0]).shape == (0, N_DIM)


def test_sift_brightness_invariance():
    patches = np.random.default_rng(3).integers(
        20, 200, (8, 64, 64)).astype(np.uint8)
    bright = np.clip(patches.astype(np.int32) + 40, 0, 255).astype(np.uint8)
    assert np.abs(_describe(bright) - _describe(patches)).mean() < 0.01


def test_sift_verification_quality():
    p1, p2, labels = synth_patch_pairs(np.random.default_rng(11),
                                       n_pairs=512, shift=4, noise=0.12)
    m = verification(sift_describe(p1, device="cpu"),
                     sift_describe(p2, device="cpu"), labels)
    assert m["auc"] > 0.98
    assert m["fpr95"] < 0.2
