"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper card and ``nvcc``; elsewhere each one
skips with the reason. Run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda -q``. chip_smoke.py
holds the same kernels against the same plain versions at the shapes of
the main path.
"""

import numpy as np
import pytest
import torch

from opencv_dlco_tpu_torch.ops import fused_rda as fr
from opencv_dlco_tpu_torch.ops.pair_distance_fused import (
    ring_distances_fused,
    ring_distances_plain,
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_dim", [16, 80])
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
    f = torch.zeros((1024, 4096), device=dev)
    pt = torch.zeros((2, 4096, 8), device=dev)
    with pytest.raises(NotImplementedError):
        ring_distances_fused(f, pt, pt, bf16=False)
