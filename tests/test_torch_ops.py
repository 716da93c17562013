"""The port's ops held against the JAX package on the same numpy inputs.

Patch transform, pooling-region bank, ring distances (f32 against JAX
HIGHEST; the plain version of kernel A against the Pallas kernel in
interpret mode), the sorted hinge, the ROC statistics and PR filter
selection.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opencv_dlco_tpu.models.select import select_pr_filters as jax_select
from opencv_dlco_tpu.models.select import selected_pr_geometry as jax_geom
from opencv_dlco_tpu.ops.hinge import hinge_sum_sorted as jax_hinge
from opencv_dlco_tpu.ops.pair_distance import ring_distances as jax_ring
from opencv_dlco_tpu.ops.pair_distance_pallas import ring_distances_fused as jax_fused
from opencv_dlco_tpu.ops.patch_transform import batch_patch_transform as jax_pt
from opencv_dlco_tpu.ops.pool_regions import build_filter_bank as jax_bank
from opencv_dlco_tpu.ops.pool_regions import pr_params
from opencv_dlco_tpu.ops.roc import roc_stats as jax_roc
from opencv_dlco_tpu.utils.configs import DescriptorConfig as JaxDescCfg
from opencv_dlco_tpu.utils.configs import PoolRegionConfig as JaxPoolCfg

from opencv_dlco_tpu_torch.models.select import (
    select_pr_filters,
    selected_pr_geometry,
)
from opencv_dlco_tpu_torch.ops.hinge import hinge_sum_sorted
from opencv_dlco_tpu_torch.ops.pair_distance import ring_distances
from opencv_dlco_tpu_torch.ops.pair_distance_fused import (
    TF,
    TP,
    pair_columns,
    ring_distances_fused,
    ring_distances_plain,
)
from opencv_dlco_tpu_torch.ops.patch_transform import batch_patch_transform
from opencv_dlco_tpu_torch.ops.pool_regions import build_filter_bank
from opencv_dlco_tpu_torch.ops.roc import roc_stats
from opencv_dlco_tpu_torch.utils.configs import DescriptorConfig, PoolRegionConfig

from oracles import random_patches

# 128 rings = 1024 filters, the JAX fused-kernel tests' bank
BANK = dict(nr=16, nphi=2, nsigma=4)


@pytest.fixture(scope="module")
def bank():
    _, _, filters = build_filter_bank(PoolRegionConfig(**BANK))
    return filters


@pytest.fixture(scope="module")
def transforms():
    rng = np.random.default_rng(5)
    patches = random_patches(rng, 12)
    ours = batch_patch_transform(torch.from_numpy(patches)).numpy()
    ref = np.array(jax_pt(jnp.asarray(patches)))  # writable copy
    return ours, ref


@pytest.mark.parametrize("grid", [dict(nr=6, nphi=2, nsigma=3), BANK])
def test_filter_bank_bit_equal(grid):
    ours = build_filter_bank(PoolRegionConfig(**grid))
    ref = jax_bank(JaxPoolCfg(**grid))
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_patch_transform_matches_jax(transforms):
    ours, ref = transforms
    assert ours.shape == ref.shape == (12, 4096, 8)
    # f32 matmul/atan2 rounding differs by ulps between the two backends
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("norm", [False, True])
def test_patch_transform_options(norm):
    """Unnormalised and flat (zero-contrast) patches take the same branches."""
    rng = np.random.default_rng(6)
    patches = random_patches(rng, 3)
    patches[0] = 128  # flat patch: the t > 1e-4 guard skips normalisation
    ours = batch_patch_transform(torch.from_numpy(patches),
                                 DescriptorConfig(norm=norm)).numpy()
    ref = np.asarray(jax_pt(jnp.asarray(patches), JaxDescCfg(norm=norm)))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_ring_distances_f32_matches_jax_highest(bank, transforms):
    ours_pt, ref_pt = transforms
    f = torch.from_numpy(bank)
    ours = ring_distances(f, torch.from_numpy(ours_pt[:6]),
                          torch.from_numpy(ours_pt[6:])).numpy()
    ref = np.asarray(jax_ring(jnp.asarray(bank), jnp.asarray(ref_pt[:6]),
                              jnp.asarray(ref_pt[6:])))
    assert ours.shape == (6, 128)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_pairs", [6, 5])
def test_kernel_a_plain_matches_pallas_bf16(bank, transforms, n_pairs):
    """Kernel A's plain version (what the CPU wrapper runs) against the
    Pallas kernel in interpret mode, both bf16 inputs: the same products
    rounded the same way, summed in another order."""
    _, ref_pt = transforms
    pt1, pt2 = ref_pt[:n_pairs], ref_pt[6:6 + n_pairs]
    ours = ring_distances_fused(torch.from_numpy(bank), torch.from_numpy(pt1),
                                torch.from_numpy(pt2), bf16=True).numpy()
    ref = np.asarray(jax_fused(jnp.asarray(bank), jnp.asarray(pt1),
                               jnp.asarray(pt2), interpret=True, bf16=True))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)
    # and bf16 against the f32 route: the JAX suite's bf16 bound
    f32 = ring_distances_plain(torch.from_numpy(bank), torch.from_numpy(pt1),
                               torch.from_numpy(pt2)).numpy()
    assert np.median(np.abs(ours - f32) / (np.abs(f32) + 1e-3)) < 2e-2


def test_kernel_a_rejects_bad_shapes(bank, transforms):
    pt = torch.from_numpy(transforms[0][:2])
    with pytest.raises(ValueError):
        ring_distances_fused(torch.from_numpy(bank[:100]), pt, pt, bf16=True)
    with pytest.raises(ValueError):
        ring_distances_fused(torch.from_numpy(bank), pt, pt[:, :100],
                             bf16=True)
    with pytest.raises(ValueError):  # a multiple of 64, not of the tile
        ring_distances_fused(torch.from_numpy(bank[:TF + 64]), pt, pt,
                             bf16=True)


@pytest.mark.parametrize("n_pairs", [1, TP, TP + 1])
def test_pair_columns_pad_to_the_pair_tile(transforms, n_pairs):
    """Kernel A's column operand: pairs zero-padded to a multiple of TP,
    row 8 * p + c = pair p's channel c, bf16, contiguous in pixels."""
    pt = torch.from_numpy(np.concatenate([transforms[0]] * 3)[:n_pairs])
    cols = pair_columns(pt)
    n_pad = -(-n_pairs // TP) * TP
    assert cols.shape == (n_pad, 8, 4096) and cols.dtype == torch.bfloat16
    assert cols.is_contiguous()
    assert torch.equal(cols[:n_pairs], pt.transpose(1, 2).to(torch.bfloat16))
    assert not bool(cols[n_pairs:].any())


def _kernel_a_tiled(bank, pt1, pt2):
    """Kernel A's dataflow in plain PyTorch: (TF filters) x (TP pairs, both
    sides as one 2 x TP x 8-column operand) tiles of bf16 products with f32
    accumulation, then the epilogue per tile: truncate, square the side
    difference, sum 8 channels and each ring's 8 rows."""
    f = torch.from_numpy(bank).to(torch.bfloat16).float()
    c1, c2 = pair_columns(pt1), pair_columns(pt2)
    n_pad, _, npix = c1.shape
    out = torch.zeros((n_pad, f.shape[0] // 8))
    for f0 in range(0, f.shape[0], TF):
        for p0 in range(0, n_pad, TP):
            b = torch.cat([c1[p0:p0 + TP].reshape(-1, npix),
                           c2[p0:p0 + TP].reshape(-1, npix)]).float()
            acc = f[f0:f0 + TF] @ b.T                      # (TF, 2 * TP * 8)
            d = (torch.clamp(acc[:, TP * 8:], max=1.0)
                 - torch.clamp(acc[:, :TP * 8], max=1.0))
            e = (d * d).reshape(TF // 8, 8, TP, 8).sum(dim=(1, 3))
            out[p0:p0 + TP, f0 // 8:(f0 + TF) // 8] = e.T
    return out[:pt1.shape[0]]


def test_kernel_a_tiled_emulation_matches_plain_and_pallas(bank, transforms):
    """The tiled emulation of kernel A (a pair count that is not a
    multiple of TP, 8 filter tiles) against its plain version and the
    Pallas kernel in interpret mode, at kernel A's tolerance."""
    _, ref_pt = transforms
    pt1, pt2 = ref_pt[:5], ref_pt[6:11]
    ours = _kernel_a_tiled(bank, torch.from_numpy(pt1),
                           torch.from_numpy(pt2)).numpy()
    plain = ring_distances_plain(torch.from_numpy(bank), torch.from_numpy(pt1),
                                 torch.from_numpy(pt2), bf16=True).numpy()
    ref = np.asarray(jax_fused(jnp.asarray(bank), jnp.asarray(pt1),
                               jnp.asarray(pt2), interpret=True, bf16=True))
    np.testing.assert_allclose(ours, plain, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(701, 1203), (3, 50)])
def test_hinge_sorted_matches_jax(shape):
    rng = np.random.default_rng(7)
    pos = rng.normal(size=shape[0]).astype(np.float32)
    neg = (rng.normal(size=shape[1]) + 0.7).astype(np.float32)
    ours = float(hinge_sum_sorted(torch.from_numpy(pos),
                                  torch.from_numpy(neg)))
    ref = float(jax_hinge(jnp.asarray(pos), jnp.asarray(neg)))
    assert abs(ours - ref) <= 1e-5 * abs(ref)


def test_hinge_sorted_batched_rows():
    """Leading dims are sweep entries: each row equals its own 1-D call."""
    rng = np.random.default_rng(8)
    pos = rng.normal(size=(4, 300)).astype(np.float32)
    neg = rng.normal(size=(4, 400)).astype(np.float32)
    got = hinge_sum_sorted(torch.from_numpy(pos), torch.from_numpy(neg))
    for i in range(4):
        ref = float(jax_hinge(jnp.asarray(pos[i]), jnp.asarray(neg[i])))
        assert abs(float(got[i]) - ref) <= 1e-5 * abs(ref)


def test_roc_stats_matches_jax():
    rng = np.random.default_rng(9)
    labels = (rng.random(5000) < 0.5).astype(np.uint8)
    dists = (rng.normal(size=5000) + 1.0 - labels).astype(np.float32)
    dists[:50] = 0.25  # ties: the stable sort keeps the same rank order
    f, a = roc_stats(torch.from_numpy(dists), torch.from_numpy(labels))
    rf, ra = jax_roc(jnp.asarray(dists), jnp.asarray(labels))
    assert float(f) == pytest.approx(float(rf), abs=1e-6)
    assert float(a) == pytest.approx(float(ra), abs=1e-5)
    # batched over model rows
    both = torch.from_numpy(np.stack([dists, -dists]))
    fb, ab = roc_stats(both, torch.from_numpy(labels))
    rf2, ra2 = jax_roc(jnp.asarray(-dists), jnp.asarray(labels))
    assert float(fb[0]) == pytest.approx(float(rf), abs=1e-6)
    assert float(fb[1]) == pytest.approx(float(rf2), abs=1e-6)
    assert float(ab[1]) == pytest.approx(float(ra2), abs=1e-5)


@pytest.mark.parametrize("grid", [dict(nr=6, nphi=2, nsigma=3), {}])
def test_pr_selection_matches_jax(grid):
    """Filter selection and the reference's dup-row geometry count, on
    banks with duplicate rows (r = 0 rings), for sparse to dense w."""
    params = pr_params(JaxPoolCfg(**grid))
    n_rings = params.shape[0] // 8
    rng = np.random.default_rng(10)
    for density in (0.0, 0.01, 0.3, 1.0):
        w = (rng.random(n_rings) < density) * rng.random(n_rings)
        assert selected_pr_geometry(params, w) == jax_geom(params, w)
    if grid:
        _, _, filters = jax_bank(JaxPoolCfg(**grid))
        w = (rng.random(n_rings) < 0.5).astype(np.float32)
        np.testing.assert_array_equal(select_pr_filters(filters, w),
                                      jax_select(filters, w))


def test_unprojected_diffs_and_model_stats_match_jax(bank, transforms):
    from opencv_dlco_tpu.models.select import compute_pr_stats as jax_stats
    from opencv_dlco_tpu.ops.pair_distance import unprojected_diffs as jax_un
    from opencv_dlco_tpu_torch.models.select import compute_pr_stats
    from opencv_dlco_tpu_torch.ops.pair_distance import unprojected_diffs

    ours_pt, ref_pt = transforms
    sel = bank[::37]
    ours = unprojected_diffs(torch.from_numpy(sel),
                             torch.from_numpy(ours_pt[:6]),
                             torch.from_numpy(ours_pt[6:])).numpy()
    ref = np.asarray(jax_un(jnp.asarray(sel), jnp.asarray(ref_pt[:6]),
                            jnp.asarray(ref_pt[6:])))
    assert ours.shape == ref.shape == (6, sel.shape[0] * 8)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)

    rng = np.random.default_rng(11)
    params = pr_params(JaxPoolCfg(**BANK))
    dists = np.abs(rng.normal(size=(400, 128))).astype(np.float32)
    labels = (rng.random(400) < 0.5).astype(np.uint8)
    dists[labels == 1, :10] *= 0.3
    w = (rng.random(128) < 0.2) * rng.random(128)
    for max_dim in (-1, 8):
        got = compute_pr_stats(params, torch.from_numpy(dists),
                               torch.from_numpy(labels), w, max_dim=max_dim)
        exp = jax_stats(params, jnp.asarray(dists), jnp.asarray(labels), w,
                        max_dim=max_dim)
        assert got.keys() == exp.keys()
        for k in got:
            assert got[k] == pytest.approx(exp[k], abs=1e-6)
