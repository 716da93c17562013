"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper card and ``nvcc``; elsewhere each one
skips with the reason. Run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda -q``. chip_smoke.py
holds the same kernels against the same plain versions at the shapes of
the main path.
"""

import hashlib

import numpy as np
import pytest
import torch

from opencv_dlco_tpu_torch.ops import fused_rda as fr
from opencv_dlco_tpu_torch.ops import hinge, knn_fused
from opencv_dlco_tpu_torch.ops.pair_distance_fused import (
    ring_distances_fused,
    ring_distances_plain,
    split_bank,
)
from opencv_dlco_tpu_torch.ops.patch_transform import batch_patch_transform
from opencv_dlco_tpu_torch.ops.pool_regions import build_filter_bank
from opencv_dlco_tpu_torch.utils.configs import PoolRegionConfig

pytestmark = pytest.mark.cuda

BF16 = dict(rtol=5e-3, atol=0.5)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _splits(dev, dtype, n=1024, f=384, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.abs(rng.normal(1.0, 0.5, (n, f))).astype(np.float32)
    neg = np.abs(rng.normal(1.2, 0.5, (n, f))).astype(np.float32)
    return (torch.from_numpy(pos).to(dev).to(dtype),
            torch.from_numpy(neg).to(dev).to(dtype))


def test_kernel_a_matches_plain(dev):
    _, _, bank = build_filter_bank(PoolRegionConfig(nr=16, nphi=2, nsigma=4))
    rng = np.random.default_rng(1)
    patches = torch.from_numpy(rng.integers(0, 256, (42, 64, 64),
                                            dtype=np.uint8)).to(dev)
    pt = batch_patch_transform(patches)
    f = torch.from_numpy(bank).to(dev)
    out = ring_distances_fused(f, pt[:21], pt[21:], bf16=True)
    ref = ring_distances_plain(f, pt[:21], pt[21:], bf16=True)
    torch.cuda.synchronize()
    assert out.shape == (21, 128)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("nf,n_pairs", [(1024, 37), (2560, 45), (1152, 19)])
def test_kernel_a_matches_plain_on_ragged_tiles(dev, nf, n_pairs):
    """Pair counts that are not a multiple of the 16-pair tile, at the small
    bank (8 filter tiles), at 20 filter tiles (one full raster group of 16
    and a partial one of 4) and at 9 (one partial group)."""
    rng = np.random.default_rng(nf + n_pairs)
    if nf == 1024:
        _, _, bank = build_filter_bank(PoolRegionConfig(nr=16, nphi=2,
                                                        nsigma=4))
    else:  # ring-like rows: nonnegative weights that sum to ~1
        bank = rng.random((nf, 4096)).astype(np.float32) * (2.0 / 4096)
    patches = torch.from_numpy(rng.integers(0, 256, (2 * n_pairs, 64, 64),
                                            dtype=np.uint8)).to(dev)
    pt = batch_patch_transform(patches)
    f = torch.from_numpy(bank).to(dev)
    before = ring_distances_fused.launches
    out = ring_distances_fused(f, pt[:n_pairs], pt[n_pairs:], bf16=True)
    assert ring_distances_fused.launches == before + 1
    ref = ring_distances_plain(f, pt[:n_pairs], pt[n_pairs:], bf16=True)
    torch.cuda.synchronize()
    assert out.shape == (n_pairs, nf // 8)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


#: kernel A's f32 mode against the plain version in f32 (TF32 off): the
#: worst row's relative L2 error (a 3xTF32 product leaves ~1e-6)
A_F32_ROW_ERR = 1e-5
#: sha256 of the bf16 mode's rows on _fixed_bf16_input, as the kernel
#: before the f32 mode gave them (NVIDIA H100 80GB HBM3)
A_BF16_FIXED_SHA256 = ("dbeea40f11b0faaa76561b83634cad06"
                       "306793bca8a9fbbda2ffaa28996600e5")


def _row_err(got, ref):
    return float(((got - ref).norm(dim=1)
                  / ref.norm(dim=1).clamp_min(1e-30)).max())


def _pairs(dev, n_pairs, seed):
    rng = np.random.default_rng(seed)
    patches = torch.from_numpy(rng.integers(0, 256, (2 * n_pairs, 64, 64),
                                            dtype=np.uint8)).to(dev)
    pt = batch_patch_transform(patches)
    return pt[:n_pairs], pt[n_pairs:]


@pytest.fixture(scope="module")
def m50_bank(dev):
    """The m50 bank (40,960 filters x 4,096 pixels) and its split planes."""
    _, _, bank = build_filter_bank(PoolRegionConfig())
    f = torch.from_numpy(bank).to(dev)
    return f, split_bank(f)


@pytest.mark.parametrize("n_pairs", [256, 8192])
def test_kernel_a_f32_matches_plain_at_the_m50_bank(dev, m50_bank, n_pairs):
    f, planes = m50_bank
    pt1, pt2 = _pairs(dev, n_pairs, n_pairs)
    before = (ring_distances_fused.launches,
              ring_distances_fused.launches_f32)
    out = ring_distances_fused(planes, pt1, pt2)
    assert (ring_distances_fused.launches,
            ring_distances_fused.launches_f32) == (before[0],
                                                   before[1] + 1)
    assert out.shape == (n_pairs, 5120)
    # the plain version in blocks of 256 pairs (its whole-block f32
    # products at 8,192 pairs would take ~21 GB)
    for s0 in range(0, n_pairs, 256):
        ref = ring_distances_plain(f, pt1[s0:s0 + 256], pt2[s0:s0 + 256])
        assert _row_err(out[s0:s0 + 256], ref) <= A_F32_ROW_ERR, s0
    # the bank split in the call gives the same rows
    assert torch.equal(ring_distances_fused(f, pt1[:40], pt2[:40]),
                       out[:40])


@pytest.mark.parametrize("nf,n_pairs", [(1024, 37), (2560, 45), (1152, 19),
                                        (1024, 1)])
def test_kernel_a_f32_on_ragged_tiles(dev, nf, n_pairs):
    """Pair counts that are not a multiple of the f32 mode's 8-pair tile,
    at 8, 20 (a full raster group and a partial one) and 9 filter tiles."""
    rng = np.random.default_rng(nf * n_pairs)
    if nf == 1024:
        _, _, bank = build_filter_bank(PoolRegionConfig(nr=16, nphi=2,
                                                        nsigma=4))
    else:  # ring-like rows: nonnegative weights that sum to ~1
        bank = rng.random((nf, 4096)).astype(np.float32) * (2.0 / 4096)
    f = torch.from_numpy(bank).to(dev)
    pt1, pt2 = _pairs(dev, n_pairs, nf + n_pairs)
    out = ring_distances_fused(f, pt1, pt2)
    ref = ring_distances_plain(f, pt1, pt2)
    assert out.shape == (n_pairs, nf // 8)
    assert _row_err(out, ref) <= A_F32_ROW_ERR


def test_kernel_a_f32_straddles_the_truncation(dev):
    """Transforms scaled so that about half the pooled values pass 1: the
    truncation cuts them in the kernel's arithmetic as in the plain
    version's."""
    _, _, bank = build_filter_bank(PoolRegionConfig(nr=16, nphi=2, nsigma=4))
    f = torch.from_numpy(bank).to(dev)
    pt1, pt2 = _pairs(dev, 40, 5)
    scale = 1.0 / float(torch.matmul(f, pt1).median())
    pt1, pt2 = pt1 * scale, pt2 * scale
    cut = float((torch.matmul(f, pt1) > 1).float().mean())
    assert 0.3 < cut < 0.7, cut
    out = ring_distances_fused(f, pt1, pt2)
    ref = ring_distances_plain(f, pt1, pt2)
    assert _row_err(out, ref) <= A_F32_ROW_ERR


def test_kernel_a_f32_keeps_a_nan(dev):
    """A NaN in one pair's patch transform gives that pair a non-finite
    row (so stage 3's finite check fires) and leaves the others."""
    _, _, bank = build_filter_bank(PoolRegionConfig(nr=16, nphi=2, nsigma=4))
    f = torch.from_numpy(bank).to(dev)
    pt1, pt2 = _pairs(dev, 20, 3)
    pt1 = pt1.clone()
    pt1[11, 1234, 5] = float("nan")
    out = ring_distances_fused(f, pt1, pt2)
    finite = torch.isfinite(out).all(dim=1).cpu().numpy()
    assert not finite[11] and finite.sum() == 19
    keep = torch.from_numpy(finite).to(dev)
    ref = ring_distances_plain(f, pt1[keep], pt2[keep])
    assert _row_err(out[keep], ref) <= A_F32_ROW_ERR


def _fixed_bf16_input(dev):
    """The small bank and 24 pairs of transforms drawn from a fixed seed."""
    _, _, bank = build_filter_bank(PoolRegionConfig(nr=16, nphi=2, nsigma=4))
    rng = np.random.default_rng(2215)
    pt = rng.random((48, 4096, 8)).astype(np.float32) * 2.0
    return torch.from_numpy(bank).to(dev), torch.from_numpy(pt).to(dev)


def test_kernel_a_bf16_rows_unchanged(dev):
    f, pt = _fixed_bf16_input(dev)
    out = ring_distances_fused(f, pt[:24], pt[24:], bf16=True)
    got = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    assert got == A_BF16_FIXED_SHA256


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_dim", [16, 80, 300])
def test_kernel_b_matches_plain(dev, dtype, s_dim):
    pos, neg = _splits(dev, dtype)
    mu = torch.linspace(0.005, 0.08, s_dim, device=dev)
    gamma = torch.linspace(0.02, 0.5, s_dim, device=dev)
    w0 = torch.zeros((s_dim, 384), device=dev)
    offs = fr.draw_block_offsets(torch.Generator().manual_seed(2), 5, 1024,
                                 1024, 256, 128)
    w, df, t = fr.fused_block_train_wide(pos, neg, w0, w0, 0, mu, gamma,
                                         offs, batch=256)
    w_r, df_r, _ = fr.fused_block_train_wide_plain(pos, neg, w0, w0, 0, mu,
                                                   gamma, offs, batch=256)
    torch.cuda.synchronize()
    np.testing.assert_allclose((df * t).cpu().numpy(),
                               (df_r * t).cpu().numpy(), **BF16)


@pytest.mark.parametrize("batch,tile_b", [(384, 128), (512, 256), (256, 64)])
def test_kernel_b_bf16_matches_plain_at_other_blockings(dev, batch, tile_b):
    """The bf16 route with an odd number of tile_b blocks and with other
    tile_b than the solver's 128 (one block at a time in phase 2)."""
    pos, neg = _splits(dev, torch.bfloat16, seed=8)
    mu = torch.linspace(0.005, 0.08, 80, device=dev)
    gamma = torch.linspace(0.02, 0.5, 80, device=dev)
    w0 = torch.zeros((80, 384), device=dev)
    offs = fr.draw_block_offsets(torch.Generator().manual_seed(tile_b), 4,
                                 1024, 1024, batch, tile_b)
    _, df, t = fr.fused_block_train_wide(pos, neg, w0, w0, 0, mu, gamma, offs,
                                         batch=batch, tile_b=tile_b)
    _, df_r, _ = fr.fused_block_train_wide_plain(pos, neg, w0, w0, 0, mu,
                                                 gamma, offs, batch=batch,
                                                 tile_b=tile_b)
    torch.cuda.synchronize()
    np.testing.assert_allclose((df * t).cpu().numpy(),
                               (df_r * t).cpu().numpy(), **BF16)


def _production_b(dev, n_steps, seed):
    """Kernel B at the PR grid's shape: S 256, F 5120, batch 2048, bf16."""
    pos, neg = _splits(dev, torch.bfloat16, n=6144, f=5120, seed=seed)
    s_dim = 256
    mu = torch.linspace(0.005, 0.08, s_dim, device=dev)
    gamma = torch.linspace(0.02, 0.5, s_dim, device=dev)
    w0 = torch.zeros((s_dim, 5120), device=dev)
    offs = fr.draw_block_offsets(torch.Generator().manual_seed(seed),
                                 n_steps, 6144, 6144, 2048, 128)
    return (pos, neg, w0, w0, 0, mu, gamma, offs)


def test_kernel_b_matches_plain_at_production_shape(dev):
    args = _production_b(dev, 4, seed=5)
    w, df, t = fr.fused_block_train_wide(*args, batch=2048)
    _, df_r, _ = fr.fused_block_train_wide_plain(*args, batch=2048)
    torch.cuda.synchronize()
    assert t == 4 * 2048
    np.testing.assert_allclose((df * t).cpu().numpy(),
                               (df_r * t).cpu().numpy(), **BF16)


def test_kernel_b_reruns_bit_identical(dev):
    """No atomics and a fixed summation order: the same inputs give the
    same df bit for bit (the sweep's ckpt_every resume identity)."""
    args = _production_b(dev, 3, seed=6)
    _, df1, _ = fr.fused_block_train_wide(*args, batch=2048)
    _, df2, _ = fr.fused_block_train_wide(*args, batch=2048)
    torch.cuda.synchronize()
    assert torch.equal(df1, df2)
    assert bool(df1.any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_dim", [1, 8])
def test_kernels_c_and_d_match_plain(dev, dtype, s_dim):
    pos, neg = _splits(dev, dtype, seed=3)
    mu = torch.linspace(0.005, 0.08, s_dim, device=dev)
    gamma = torch.linspace(0.02, 0.5, s_dim, device=dev)
    w0 = torch.zeros((s_dim, 384), device=dev)
    offs = fr.draw_block_offsets(torch.Generator().manual_seed(4), 5, 1024,
                                 1024, 256, 128)
    w, df, t = fr.fused_block_train(pos, neg, w0, w0, 0, mu, gamma, offs,
                                    batch=256)
    _, df_r, _ = fr.fused_block_train_plain(pos, neg, w0, w0, 0, mu, gamma,
                                            offs, batch=256)
    wr = torch.rand((s_dim, 384), device=dev) * 0.05
    g = fr.fused_block_grad(pos, neg, wr, 2, 3, batch=256)
    g_r = fr.fused_block_grad_plain(pos, neg, wr, 2, 3, batch=256)
    torch.cuda.synchronize()
    np.testing.assert_allclose((df * t).cpu().numpy(),
                               (df_r * t).cpu().numpy(), **BF16)
    np.testing.assert_allclose(g.cpu().numpy(), g_r.cpu().numpy(), **BF16)


def test_wrappers_raise_on_shapes_the_kernels_cannot_take(dev):
    pos, neg = _splits(dev, torch.float32, f=100)
    w = torch.zeros((16, 100), device=dev)
    mu = torch.ones(16, device=dev)
    with pytest.raises(ValueError):
        fr.fused_block_train_wide(pos, neg, w, w, 0, mu, mu, [[0, 0]],
                                  batch=256)
    pos16, neg16 = _splits(dev, torch.bfloat16)
    w16 = torch.zeros((16, 384), device=dev)
    with pytest.raises(ValueError):  # bf16 route: batch % 128 != 0
        fr.fused_block_train_wide(pos16, neg16, w16, w16, 0, mu, mu,
                                  [[0, 0]], batch=192, tile_b=64)
    f = torch.zeros((1024, 4096), device=dev)
    pt = torch.zeros((2, 4096, 8), device=dev)
    with pytest.raises(ValueError):  # split planes are the f32 mode's
        ring_distances_fused(split_bank(f), pt, pt, bf16=True)
    with pytest.raises(ValueError):  # planes (3, ...) are no split bank
        ring_distances_fused(torch.zeros((3, 1024, 4096), device=dev), pt,
                             pt)
    with pytest.raises(ValueError):  # a multiple of 64 filters, not of 128
        ring_distances_fused(f[:192], pt, pt, bf16=True)
    with pytest.raises(ValueError):
        ring_distances_fused(f[:192], pt, pt)


# P = N = 50,000 (the bench's shape) and 8,192; P on both sides of a
# CTA's 1,024 positives and below it; N below one 256-negative slice, not a
# multiple of 4, and 0
@pytest.mark.parametrize("n_pos,n_neg", [
    (50_000, 50_000), (8192, 8192), (700, 2500), (3, 5), (1, 3000),
    (hinge.TILE_P - 1, 4099), (hinge.TILE_P + 1, 4099), (2500, 100),
    (2500, 0)])
def test_kernel_e_matches_plain(dev, n_pos, n_neg):
    rng = np.random.default_rng(n_pos)
    pos = torch.from_numpy(rng.normal(1.0, 0.6, n_pos).astype(np.float32))
    neg = torch.from_numpy(rng.normal(2.0, 0.8, n_neg).astype(np.float32))
    before = hinge.hinge_sum_blockwise.launches
    got = hinge.hinge_sum_blockwise(pos.to(dev), neg.to(dev))
    assert hinge.hinge_sum_blockwise.launches == before + 1
    ref = hinge.hinge_partials_plain(pos.to(dev), neg.to(dev))
    srt = float(hinge.hinge_sum_sorted(pos.to(dev), neg.to(dev)))
    # f32 sums of up to 2.5e9 terms in other orders
    assert float(got) == pytest.approx(float(ref.sum()), rel=1e-5)
    assert float(got) == pytest.approx(srt, rel=1e-5)
    # per positive: sums of non-negative terms, each within a relative 1e-5
    part = hinge.hinge_partials(pos.to(dev), neg.to(dev))
    np.testing.assert_allclose(part.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5)
    # the slices are combined in a fixed order: the same bits every call
    again = hinge.hinge_sum_blockwise(pos.to(dev), neg.to(dev))
    assert again.cpu().numpy().tobytes() == got.cpu().numpy().tobytes()
    assert torch.equal(hinge.hinge_partials(pos.to(dev), neg.to(dev)), part)


def test_kernel_e_empty_positives(dev):
    before = hinge.hinge_sum_blockwise.launches
    got = hinge.hinge_sum_blockwise(torch.zeros(0, device=dev),
                                    torch.ones(10, device=dev))
    assert float(got) == 0.0 and got.device.type == "cuda"
    assert hinge.hinge_sum_blockwise.launches == before


def test_kernel_e_unaligned_negatives(dev):
    """A view whose data starts off a 16-byte boundary is copied first."""
    rng = np.random.default_rng(3)
    neg = torch.from_numpy(rng.normal(2.0, 0.8, 3001).astype(np.float32))
    pos = torch.from_numpy(rng.normal(1.0, 0.6, 2000).astype(np.float32))
    got = float(hinge.hinge_sum_blockwise(pos.to(dev), neg.to(dev)[1:]))
    ref = float(hinge.hinge_partials_plain(pos, neg[1:]).sum())
    assert got == pytest.approx(ref, rel=1e-5)


def _clustered(dev, n, m, d, seed, scale=1.0):
    """Realistic-margin descriptors (tests/test_knn_pallas.py)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    centres = torch.randn((m, d), generator=g, device=dev)
    q = centres[:n] + 0.05 * torch.randn((n, d), generator=g, device=dev)
    t = centres[torch.randperm(m, generator=g, device=dev)]
    return q * scale, t * scale


@pytest.mark.parametrize("k", [2, 3, 10, 16])
@pytest.mark.parametrize("d", [64, 120])
def test_kernels_f_and_h_match_plain_f32(dev, k, d):
    # unit-scale descriptors: f32 rounding of |q|^2 + |t|^2 stays far
    # below the 1e-5 tolerance
    q, t = _clustered(dev, 3000, 5000, d, seed=k, scale=d ** -0.5)
    fn = (lambda a, b: knn_fused.knn2_fused(a, b, bf16=False)) if k == 2 \
        else (lambda a, b: knn_fused.knnk_fused(a, b, k, bf16=False))
    dk, ik = fn(q, t)
    dp, ip = knn_fused.knn_plain(q, t, k, bf16=False)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(ik.cpu().numpy(), ip.cpu().numpy())
    np.testing.assert_allclose(dk.cpu().numpy(), dp.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [2, 10])
@pytest.mark.parametrize("d", [64, 120, 600])
def test_kernels_f_and_h_bf16_match_identity(dev, k, d):
    """bf16 mode against the bf16 plain version: d 120 takes the padding
    to a multiple of 16, d 600 (608 padded) three D chunks."""
    from opencv_dlco_tpu_torch.ops.knn import ratio_test

    q, t = _clustered(dev, 4096, 8192, d, seed=3)
    fn = (lambda a, b: knn_fused.knn2_fused(a, b)) if k == 2 \
        else (lambda a, b: knn_fused.knnk_fused(a, b, k))
    dk, ik = fn(q, t)
    dp, ip = knn_fused.knn_plain(q, t, k, bf16=True)
    torch.cuda.synchronize()
    # tensor-core f32 accumulation vs cuBLAS in another order: match
    # identity on every one of the k columns, not only the first
    same = ik == ip
    assert same.float().mean(dim=0).min() >= 0.99
    mk, _ = ratio_test(dk, ik)
    mp, _ = ratio_test(dp, ip)
    assert (mk == mp).float().mean() >= 0.99
    # agreeing entries: the two orders differ by the f32 rounding of the
    # expanded form, whose magnitude is |q|^2 + |t|^2
    qb, tb = q.bfloat16().float(), t.bfloat16().float()
    mag = (qb * qb).sum(1)[:, None] + (tb * tb).sum(1)[ip.long()]
    err = (dk - dp).abs()[same]
    assert bool((err <= 1e-3 * dp.abs()[same] + 1e-5 * mag[same]).all())


@pytest.mark.parametrize("k", [2, 10])
@pytest.mark.parametrize("d", [200, 576])
def test_kernels_f_and_h_wide_f32_launch_and_match(dev, k, d):
    """Widths past one D chunk (128 f32) run on the kernel, through the
    dispatcher too, and match the plain version exactly in index."""
    from opencv_dlco_tpu_torch.ops.knn import knn_match

    q, t = _clustered(dev, 1000, 3000, d, seed=d + k, scale=d ** -0.5)
    before = (knn_fused.knn2_fused.launches, knn_fused.knnk_fused.launches)
    dk, ik = knn_match(q, t, k=k, precision="highest")
    after = (knn_fused.knn2_fused.launches, knn_fused.knnk_fused.launches)
    assert after[0 if k <= 2 else 1] == before[0 if k <= 2 else 1] + 1
    dp, ip = knn_fused.knn_plain(q, t, k, bf16=False)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(ik.cpu().numpy(), ip.cpu().numpy())
    np.testing.assert_allclose(dk.cpu().numpy(), dp.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_kernels_f_and_h_edges(dev):
    """Ragged shapes, fewer train rows than k, and ties."""
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((77, 32), generator=g, device=dev)
    t = torch.randn((130, 32), generator=g, device=dev)
    for k in (2, 5):
        fn = knn_fused.knn2_fused if k == 2 else \
            (lambda a, b, **kw: knn_fused.knnk_fused(a, b, k, **kw))
        dk, ik = fn(q, t, bf16=False)
        _, ip = knn_fused.knn_plain(q, t, k, bf16=False)
        np.testing.assert_array_equal(ik.cpu().numpy(), ip.cpu().numpy())
    dk, ik = knn_fused.knnk_fused(q, t[:5], 8, bf16=False)
    assert torch.all(ik[:, 5:] == -1) and torch.all(torch.isinf(dk[:, 5:]))
    base = torch.randn((6, 16), generator=g, device=dev)
    dup = torch.cat([base, base, base])
    _, ik = knn_fused.knnk_fused(base, dup, 3, bf16=False)
    assert torch.equal(ik.cpu(), torch.arange(6)[:, None]
                       + torch.tensor([0, 6, 12]))


@pytest.mark.parametrize("c,n,m,d", [(16, 256, 256, 64), (3, 77, 130, 120),
                                     (1, 300, 90, 64)])
def test_kernel_g_matches_plain_with_masked_rows(dev, c, n, m, d):
    """Kernel G (knn2_fused_batched, f32): one launch per batch, against
    knn_plain on the batch, with the SLAM pose chunk's masks (invalid
    queries at 1e6, invalid train rows at -1e6)."""
    _check_g_masked(dev, c, n, m, d)


@pytest.mark.parametrize("c,n,m,d", [(16, 256, 256, 48), (1, 256, 256, 48),
                                     (2, 45, 700, 48), (1, 33, 257, 200)])
def test_kernel_g_at_the_slam_chunk_and_ragged_tiles(dev, c, n, m, d):
    """G at the SLAM pose chunk's shape (16 x 256 x 256, d 48), at one
    problem, and with N and M off the 32-query and 256-row tiles (several
    train tiles, several D chunks)."""
    _check_g_masked(dev, c, n, m, d)


def _check_g_masked(dev, c, n, m, d):
    g = torch.Generator(device=dev).manual_seed(c * n + d)
    q = torch.randn((c, n, d), generator=g, device=dev) * d ** -0.5
    t = torch.randn((c, m, d), generator=g, device=dev) * d ** -0.5
    k = min(n, m) // 2
    t[:, :k] = q[:, :k] + 0.05 * d ** -0.5 * torch.randn(
        (c, k, d), generator=g, device=dev)
    vq = torch.rand((c, n), generator=g, device=dev) < 0.8
    vt = torch.rand((c, m), generator=g, device=dev) < 0.8
    q = torch.where(vq[..., None], q, torch.full_like(q, 1e6))
    t = torch.where(vt[..., None], t, torch.full_like(t, -1e6))
    before = knn_fused.knn2_fused_batched.launches
    dk, ik = knn_fused.knn2_fused_batched(q, t)
    assert knn_fused.knn2_fused_batched.launches == before + 1
    dp, ip = knn_fused.knn_plain(q, t, 2, bf16=False)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dk).all())
    np.testing.assert_array_equal(ik.cpu().numpy(), ip.cpu().numpy())
    mag = (q.double() ** 2).sum(-1)[..., None] + torch.gather(
        (t.double() ** 2).sum(-1)[:, None, :].expand(-1, n, -1), 2,
        ik.long())
    err = (dk.double() - dp.double()).abs()
    assert bool((err <= 1e-5 * dp.double().abs()
                 + 8 * 1.1920929e-07 * mag).all())
    # a masked train row is never a real query's neighbour
    picked = torch.gather(vt[:, None, :].expand(-1, n, -1), 2,
                          ik[..., :1].long())[..., 0]
    assert bool(picked[vq].all())


def _tied_clustered(dev, n, m, d, seed):
    """Realistic-margin descriptors whose train rows repeat: rows
    m/2 .. m/2 + 199 copy rows 0 .. 199 (exact ties across tiles)."""
    q, t = _clustered(dev, n, m, d, seed)
    t[m // 2:m // 2 + 200] = t[:200]
    return q.contiguous(), t.contiguous()


@pytest.mark.parametrize("k", [1, 3, 10, 16])
@pytest.mark.parametrize("d", [48, 64, 120, 600, 1400])
def test_kernel_h_bf16_ragged_with_ties(dev, k, d):
    """Kernel H's Hopper route (bf16, knn_topk.cu) against the bf16 plain
    version, with M off the 64-row tile and duplicated train rows: match
    identity on every column, and equal distances in ascending index. d 600
    keeps one warpgroup's queries resident; d 1400 streams them."""
    from opencv_dlco_tpu_torch.ops.knn import ratio_test

    q, t = _tied_clustered(dev, 3001, 4999, d, seed=k + d)
    before = knn_fused.knnk_fused.launches
    dk, ik = knn_fused.knnk_fused(q, t, k)
    assert knn_fused.knnk_fused.launches == before + 1
    dp, ip = knn_fused.knn_plain(q, t, k, bf16=True)
    torch.cuda.synchronize()
    assert dk.shape == ik.shape == (3001, k)
    same = ik == ip
    assert same.float().mean(dim=0).min() >= 0.99
    if k >= 2:
        mk, _ = ratio_test(dk, ik)
        mp, _ = ratio_test(dp, ip)
        assert (mk == mp).float().mean() >= 0.99
        tie = dk[:, 1:] == dk[:, :-1]
        assert bool((ik[:, 1:] > ik[:, :-1])[tie].all())
        assert bool((dk[:, 1:] >= dk[:, :-1]).all())
    qb, tb = q.bfloat16().float(), t.bfloat16().float()
    mag = (qb * qb).sum(1)[:, None] + (tb * tb).sum(1)[ip.long()]
    err = (dk - dp).abs()[same]
    assert bool((err <= 1e-3 * dp.abs()[same] + 1e-5 * mag[same]).all())


def test_kernel_h_fewer_train_rows_than_k(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((130, 64), generator=g, device=dev)
    t = torch.randn((5, 64), generator=g, device=dev)
    dk, ik = knn_fused.knnk_fused(q, t, 12)
    _, ip = knn_fused.knn_plain(q, t, 12, bf16=True)
    assert torch.equal(ik[:, 5:].cpu(), torch.full((130, 7), -1,
                                                   dtype=torch.int32))
    assert bool(torch.isinf(dk[:, 5:]).all())
    assert (ik[:, :5] == ip[:, :5]).float().mean() >= 0.99


def test_kernels_g_and_h_rerun_bit_identical(dev):
    q, t = _tied_clustered(dev, 4096, 8192, 64, seed=1)
    a = knn_fused.knnk_fused(q, t, 10)
    b = knn_fused.knnk_fused(q, t, 10)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    g = torch.Generator(device=dev).manual_seed(3)
    qb = torch.randn((16, 256, 48), generator=g, device=dev)
    tb = torch.randn((16, 256, 48), generator=g, device=dev)
    a = knn_fused.knn2_fused_batched(qb, tb)
    b = knn_fused.knn2_fused_batched(qb, tb)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_knn_wrappers_raise_on_shapes_the_kernels_cannot_take(dev):
    q = torch.randn((10, 64), device=dev)
    for k in (0, 17):
        with pytest.raises(ValueError):
            knn_fused.knnk_fused(q, q, k)
    with pytest.raises(ValueError):          # D differs
        knn_fused.knnk_fused(q, q[:, :32], 4)
    with pytest.raises(ValueError):          # no descriptor elements
        knn_fused.knnk_fused(q[:, :0], q[:, :0], 4)
    with pytest.raises(ValueError):          # G takes (B, N, D) only
        knn_fused.knn2_fused_batched(q, q)
    with pytest.raises(ValueError):          # batch sizes differ
        knn_fused.knn2_fused_batched(q[None], torch.cat([q[None], q[None]]))
    with pytest.raises(ValueError):
        knn_fused.knn2_fused_batched(q[None], q[None].cpu())


def _c_splits(dev, dtype, n=4096, f=1024, seed=0):
    """Splits whose rows differ by a per-row shift, so the hinge's
    violators are a mix at every step (not all rows, not none)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.rand((n, f), generator=g, device=dev) * 0.02
    neg = pos + (torch.rand((n, 1), generator=g, device=dev) - 0.5) * 0.2 \
        + torch.rand((n, f), generator=g, device=dev) * 0.01
    return pos.to(dtype), neg.to(dtype)


def _c_run(dev, dtype, s_dim, n_steps, batch, f=1024, seed=0):
    pos, neg = _c_splits(dev, dtype, f=f, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    w0 = (1.0 + torch.rand((s_dim, f), generator=g, device=dev)) * 10.0 / f
    z = torch.zeros_like(w0)
    mu = torch.linspace(0.005, 0.08, s_dim, device=dev)
    gamma = torch.linspace(0.02, 0.5, s_dim, device=dev)
    offs = fr.draw_block_offsets(torch.Generator().manual_seed(seed), n_steps,
                                 4096, 4096, batch, 128)
    args = (pos, neg, w0, z, 0, mu, gamma, offs)
    return args, fr.fused_block_train(*args, batch=batch)


@pytest.mark.parametrize("n_steps", [1, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_dim", [1, 2, 8])
def test_kernel_c_persistent_matches_plain(dev, s_dim, dtype, n_steps):
    """Kernel C's one persistent launch against its plain version at batch
    2048 (the main path's; uneven rows over the card's CTAs), F 1024: df at
    the JAX suite's f32 tolerance, df * t at its bf16 one; the gradient
    mode (kernel D) on the same splits."""
    before = fr.fused_block_train.launches
    args, (w, df, t) = _c_run(dev, dtype, s_dim, n_steps, 2048)
    assert fr.fused_block_train.launches == before + 1
    _, df_p, _ = fr.fused_block_train_plain(*args, batch=2048)
    g = fr.fused_block_grad(args[0], args[1], args[2], 3, 5, batch=2048)
    g_p = fr.fused_block_grad_plain(args[0], args[1], args[2], 3, 5,
                                    batch=2048)
    torch.cuda.synchronize()
    tol = dict(rtol=3e-5, atol=3e-4) if dtype == torch.float32 else BF16
    if dtype == torch.float32:
        np.testing.assert_allclose(df.cpu().numpy(), df_p.cpu().numpy(),
                                   **tol)
    else:
        np.testing.assert_allclose((df * t).cpu().numpy(),
                                   (df_p * t).cpu().numpy(), **tol)
    np.testing.assert_allclose(g.cpu().numpy(), g_p.cpu().numpy(), **tol)


@pytest.mark.parametrize("batch,f", [(384, 256), (128, 1000), (2048, 5120)])
def test_kernel_c_batches_off_the_row_partition(dev, batch, f):
    """Batches that split unevenly over the CTAs (384) or leave CTAs out
    (128 rows: one a CTA), F off a multiple of 1024, and the single-run
    width, S 3, f32, 5 steps."""
    args, (_, df, _) = _c_run(dev, torch.float32, 3, 5, batch, f=f, seed=2)
    _, df_p, _ = fr.fused_block_train_plain(*args, batch=batch)
    torch.cuda.synchronize()
    np.testing.assert_allclose(df.cpu().numpy(), df_p.cpu().numpy(),
                               rtol=3e-5, atol=3e-4)


def test_kernel_c_rejects_widths_it_cannot_take(dev):
    pos, neg = _c_splits(dev, torch.float32, n=512, f=100)
    w = torch.zeros((1, 100), device=dev)
    with pytest.raises(ValueError):     # F % 8 != 0
        fr.fused_block_train(pos, neg, w, w, 0, torch.ones(1, device=dev),
                             torch.ones(1, device=dev), [[0, 0]], batch=128)
    pos, neg = _c_splits(dev, torch.float32, n=512, f=5128)
    w = torch.zeros((8, 5128), device=dev)
    with pytest.raises(ValueError):     # F past 5120 at S 8
        fr.fused_block_train(pos, neg, w, w, 0, torch.ones(8, device=dev),
                             torch.ones(8, device=dev), [[0, 0]], batch=128)


def _f_tied(dev, n, m, d, seed):
    """Clustered queries against train rows of which a block repeats
    earlier rows (exact ties across tiles) where M allows."""
    q, t = _clustered(dev, n, max(m, n), d, seed)
    t = t[:m].clone()
    if m > 200:
        t[m - 100:] = t[:100]
    return q.contiguous(), t.contiguous()


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("m", [1, 63, 65, 4097])
@pytest.mark.parametrize("d", [40, 1400])
def test_kernel_f_pair_selection_with_ties(dev, k, m, d):
    """Kernel F (knn_topk.cu's pair selection, bf16) through knn_match at
    k 1 and 2: one launch; M below 2, off the 64-row tile and past a
    multiple of it; d 40 (not a multiple of 16) and d 1400 (past the
    resident limit: queries stream); against the bf16 plain version by
    match identity and with equal distances in ascending index."""
    from opencv_dlco_tpu_torch.ops.knn import knn_match, ratio_test

    q, t = _f_tied(dev, 1001, m, d, seed=m + d + k)
    before = knn_fused.knn2_fused.launches
    dk, ik = knn_match(q, t, k=k, fused=True)
    assert knn_fused.knn2_fused.launches == before + 1
    dp, ip = knn_fused.knn_plain(q, t, k, bf16=True)
    torch.cuda.synchronize()
    assert dk.shape == ik.shape == (1001, k)
    same = ik == ip
    assert same.float().mean(dim=0).min() >= 0.99
    if k == 2:
        mk, _ = ratio_test(dk, ik)
        mp, _ = ratio_test(dp, ip)
        assert (mk == mp).float().mean() >= 0.99
        tie = dk[:, 1] == dk[:, 0]
        assert bool((ik[:, 1] > ik[:, 0])[tie].all())
        if m == 1:
            assert bool((ik[:, 1] == -1).all() and torch.isinf(dk[:, 1]).all())
    qb, tb = q.bfloat16().float(), t.bfloat16().float()
    mag = (qb * qb).sum(1)[:, None] + (tb * tb).sum(1)[ip.clamp(min=0).long()]
    err = (dk - dp).abs()[same & (ip >= 0)]
    assert bool((err <= 1e-3 * dp.abs()[same & (ip >= 0)]
                 + 1e-5 * mag[same & (ip >= 0)]).all())


def test_kernels_c_and_f_rerun_bit_identical(dev):
    """Kernel C's fixed-order reduction and kernel F's selection give the
    same bits on a second call with the same inputs."""
    a = _c_run(dev, torch.float32, 1, 48, 2048, f=5120, seed=4)[1]
    b = _c_run(dev, torch.float32, 1, 48, 2048, f=5120, seed=4)[1]
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    q, t = _f_tied(dev, 8192, 8192, 64, seed=1)
    a = knn_fused.knn2_fused(q, t)
    b = knn_fused.knn2_fused(q, t)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _hold_f32_route(q, t, k, got):
    """Kernel F's or H's f32 mode (q (B, N, D), t (B, M, D)) against the
    f32 plain version: distances within rtol/atol 1e-5; indices identical
    except at near-ties (two summation orders of one f32 distance), where
    the kernel's pick lies at the plain list's distance within 1e-5
    (relative plus absolute, in f64), at most one entry in a thousand; no
    row repeats an index. Returns the number of near-tie swaps."""
    dk, ik = got
    dp, ip = knn_fused.knn_plain(q, t, k, bf16=False)
    torch.cuda.synchronize()
    assert dk.shape == ik.shape == dp.shape
    np.testing.assert_allclose(dk.cpu().numpy(), dp.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    b, r, s = (ik != ip).nonzero(as_tuple=True)
    pick = ik[b, r, s].long()
    assert bool((pick >= 0).all())
    d_pick = ((q[b, r].double() - t[b, pick].double()) ** 2).sum(-1)
    ref = dp[b, r, s].double()
    assert bool(((d_pick - ref).abs() <= 1e-5 * (1.0 + ref.abs())).all())
    assert b.numel() <= 1e-3 * ik.numel()
    srt = ik.sort(dim=-1).values
    assert not bool(((srt[..., 1:] == srt[..., :-1])
                     & (srt[..., 1:] >= 0)).any())
    return b.numel()


@pytest.mark.parametrize("k", [2, 10])
def test_kernels_f_and_h_f32_at_d576(dev, k):
    """The f32 mode at d 576 (queries streamed through the stages, 18
    K chunks of 32), M off both tile sizes: one launch a call through the
    public wrappers, held to the f32 plain version."""
    q, t = _clustered(dev, 2048, 4099, 576, seed=576 + k, scale=576 ** -0.5)
    wrapper = knn_fused.knn2_fused if k == 2 else knn_fused.knnk_fused
    before = wrapper.launches
    got = knn_fused.knn2_fused(q, t, bf16=False) if k == 2 else \
        knn_fused.knnk_fused(q, t, k, bf16=False)
    assert wrapper.launches == before + 1
    _hold_f32_route(q[None], t[None], k, (got[0][None], got[1][None]))


@pytest.mark.parametrize("k", [1, 2, 5, 10])
@pytest.mark.parametrize("b,n,m,d", [(3, 200, 333, 64), (16, 256, 256, 48),
                                     (2, 77, 1000, 300)])
def test_kernels_f_and_h_f32_batched(dev, k, b, n, m, d):
    """A leading batch axis (the launchers' B > 1: the SLAM pose chunk's
    16 x 256 x 256 at d 48 among them) against the batched plain
    version; d 300 streams the queries."""
    g = torch.Generator(device=dev).manual_seed(b * n + d + k)
    q = torch.randn((b, n, d), generator=g, device=dev) * d ** -0.5
    t = torch.randn((b, m, d), generator=g, device=dev) * d ** -0.5
    t[:, :n // 2] = q[:, :n // 2] + 0.05 * d ** -0.5 * torch.randn(
        (b, n // 2, d), generator=g, device=dev)
    wrapper = knn_fused.knn2_fused if k <= 2 else knn_fused.knnk_fused
    before = wrapper.launches
    got = knn_fused._fused_call(q, t, k, bf16=False, wrapper=wrapper)
    assert wrapper.launches == before + 1
    _hold_f32_route(q, t, k, got)


@pytest.mark.parametrize("k", [1, 2, 3, 10, 16])
@pytest.mark.parametrize("d", [48, 64, 576])
def test_kernels_f_and_h_f32_ragged_with_ties(dev, k, d):
    """The f32 mode with M off the 64- and 128-row tiles and train rows
    repeated across tiles (rows m/2 .. m/2 + 199 copy rows 0 .. 199): equal
    distances come out in ascending train index, every query's copied
    centre is found at both of its columns, and the lists hold to the
    f32 plain version."""
    n, m = 3001, 4999
    q, t = _clustered(dev, n, m, d, seed=k + d, scale=d ** -0.5)
    t[m // 2:m // 2 + 200] = t[:200]
    q, t = q.contiguous(), t.contiguous()
    dk, ik = knn_fused.knn2_fused(q, t, bf16=False) if k == 2 else \
        knn_fused.knnk_fused(q, t, k, bf16=False)
    _hold_f32_route(q[None], t[None], k, (dk[None], ik[None]))
    if k >= 2:
        tie = dk[:, 1:] == dk[:, :-1]
        assert bool((ik[:, 1:] > ik[:, :-1])[tie].all())
        assert bool((dk[:, 1:] >= dk[:, :-1]).all())
        dup = ik[:, 0] < 200          # nearest is a copied row
        assert bool(dup.any())
        assert bool((ik[dup, 1] == ik[dup, 0] + m // 2).all())
        assert bool((dk[dup, 1] == dk[dup, 0]).all())


def test_kernels_f_and_h_f32_rerun_bit_identical(dev):
    """The split and the products run in a fixed order: a second call
    with the same inputs gives the same bits (resident and streamed
    queries)."""
    for d in (64, 576):
        q, t = _clustered(dev, 4096, 8192, d, seed=d, scale=d ** -0.5)
        for k in (2, 10):
            fn = (lambda a, b: knn_fused.knn2_fused(a, b, bf16=False)) \
                if k == 2 else \
                (lambda a, b: knn_fused.knnk_fused(a, b, k, bf16=False))
            a, b = fn(q, t), fn(q, t)
            torch.cuda.synchronize()
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# -- the slice with the pair generator, SIFT and SfM -----------------------

def test_pair_generator_on_the_card_same_bits_and_gates(dev):
    """synth_patch_pairs_device on the card: two draws from one seed give
    the same bits, and 1,024 pairs at HARD_PAIR_PARAMS meet the JAX
    suite's gates against the numpy route (tests/test_data.py:109-140)."""
    from opencv_dlco_tpu_torch.data import synthetic as syn

    def draw(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return syn.synth_patch_pairs_device(1024, generator=g, device=dev,
                                            **syn.HARD_PAIR_PARAMS)

    a, b = draw(7), draw(7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    ref = syn.synth_patch_pairs(np.random.default_rng(7), n_pairs=1024,
                                **syn.HARD_PAIR_PARAMS)

    def stats(p1, p2, labels):
        d = np.abs(p1.astype(np.float32) - p2.astype(np.float32))
        return (p1.mean(), p1.std(), d[labels == 1].mean(),
                d[labels == 0].mean())

    am, asd, apos, aneg = stats(*ref)
    bm, bsd, bpos, bneg = stats(*a)
    np.testing.assert_array_equal(ref[2], a[2])
    assert abs(am - bm) < 0.05 * am and abs(asd - bsd) < 0.08 * asd
    assert apos < aneg and bpos < bneg
    assert abs(apos / aneg - bpos / bneg) < 0.1


def test_sift_describe_card_matches_cpu(dev):
    """sift_describe on the card (f32, TF32 off) against the same function
    on the CPU: abs 1e-5."""
    from opencv_dlco_tpu_torch.ops.sift import sift_describe

    patches = np.random.default_rng(3).integers(
        0, 256, (4100, 64, 64)).astype(np.uint8)
    got = sift_describe(patches, device=dev)
    assert got.device.type == "cuda"
    ref = sift_describe(patches, device="cpu")
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)


def sfm_masked_inputs(dev, n=512, d=48, n_valid=(300, 280), seed=0):
    """Two-view SfM's 2-NN inputs: descriptors of |q|^2 ~ 40 (the exported
    48-D header's scale), train rows a noisy permutation of the queries,
    invalid detections at +1e6 (queries) and -1e6 (train), scattered."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((n, d), generator=g, device=dev)
    t = q[torch.randperm(n, generator=g, device=dev)]
    t = t + 0.3 * torch.randn((n, d), generator=g, device=dev)
    vq = torch.zeros(n, dtype=torch.bool, device=dev)
    vt = torch.zeros(n, dtype=torch.bool, device=dev)
    vq[torch.randperm(n, generator=g, device=dev)[:n_valid[0]]] = True
    vt[torch.randperm(n, generator=g, device=dev)[:n_valid[1]]] = True
    q = torch.where(vq[:, None], q, torch.full_like(q, 1e6))
    t = torch.where(vt[:, None], t, torch.full_like(t, -1e6))
    return q.contiguous(), t.contiguous(), vq


def test_kernel_f_on_sfm_masked_rows(dev):
    """Kernel F through knn_match at two-view SfM's shape (512 x 512, d 48,
    bf16) with masked rows: one launch; every valid query's pair of
    indices and ratio-test decision equal to the plain version's; every
    distance (masked rows included) within 1e-3 relative plus 1e-5 of
    |q|^2 + |t|^2 of the plain one, where the indices differ (masked
    rows only: their candidates tie to f32 resolution) at the plain
    list's distance within the same tolerance."""
    from opencv_dlco_tpu_torch.ops.knn import knn_match, ratio_test

    q, t, vq = sfm_masked_inputs(dev)
    before = knn_fused.knn2_fused.launches
    dk, ik = knn_match(q, t, k=2)
    assert knn_fused.knn2_fused.launches == before + 1
    dp, ip = knn_fused.knn_plain(q, t, 2, bf16=True)
    torch.cuda.synchronize()
    assert torch.equal(ik[vq], ip[vq])
    assert torch.equal(ratio_test(dk, ik)[1][vq], ratio_test(dp, ip)[1][vq])
    qb, tb = q.bfloat16().double(), t.bfloat16().double()
    mag = ((qb * qb).sum(1)[:, None]
           + (tb * tb).sum(1)[ip.clamp(min=0).long()])
    assert bool((ip >= 0).all() and (ik >= 0).all())
    err = (dk.double() - dp.double()).abs()
    assert bool((err <= 1e-3 * dp.double().abs() + 1e-5 * mag).all())


# -- the multi-device layer: two ranks on the one card over gloo -----------

def test_two_gloo_ranks_on_the_card(dev, tmp_path):
    """Two processes on one card over gloo (NCCL refuses two ranks on one
    GPU): all_reduce and all_gather of CUDA tensors, the PR sweep chunk
    over dp through kernel B (S 32 -> 16 a rank) against one
    single-device call with the same offsets, and the dry run."""
    import json
    import os

    from opencv_dlco_tpu_torch.models.pr_rda import PRState, pr_train_chunk
    from torch_distworker import World

    rng = np.random.default_rng(3)
    inp = dict(pos=np.abs(rng.normal(1.0, 0.5, (2048, 512))).astype(
        np.float32), neg=np.abs(rng.normal(1.2, 0.5, (2048, 512))).astype(
        np.float32), mus=np.linspace(0.005, 0.05, 32).astype(np.float32),
        gammas=np.linspace(0.02, 0.2, 32).astype(np.float32), seed=7,
        batch=256, n_steps=6)
    np.savez(os.path.join(tmp_path, "inputs.npz"), **inp)
    world = World(2, "cuda", str(tmp_path)).ranks()
    pos, neg = (torch.from_numpy(inp[k]).to(dev).to(torch.bfloat16)
                for k in ("pos", "neg"))
    zeros = torch.zeros((32, 512), device=dev)
    one = pr_train_chunk(pos, neg, torch.from_numpy(inp["mus"]).to(dev),
                         torch.from_numpy(inp["gammas"]).to(dev),
                         PRState(w=zeros, df_avg=zeros.clone(), t=0),
                         torch.Generator().manual_seed(7), batch=256,
                         n_steps=6, sampling="block_fused",
                         precision="default")
    for r in world:
        assert json.loads(str(r["info"]))["backend"] == "gloo"
        np.testing.assert_array_equal(r["psum"], [10.0, 12.0, 14.0, 16.0])
        np.testing.assert_array_equal(
            r["gather"], [0.0, 1.0, 2.0, 3.0, 10.0, 11.0, 12.0, 13.0])
        assert int(r["B_launches"]) > 0
        # kernel B's per-combo work does not depend on the sweep width
        np.testing.assert_allclose(r["sw_w"], one.w.cpu().numpy(),
                                   **BF16)
        np.testing.assert_allclose(r["sw_df"], one.df_avg.cpu().numpy(),
                                   **BF16)
        run = json.loads(str(r["dryrun"]))
        assert run["mesh"] == {"dp": 1, "mp": 2} and run["pj_t"] == 1
