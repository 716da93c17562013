"""The plain versions of kernels F (fused 2-NN) and H (fused top-k) and the
port's matching front end, held against the JAX package: the Pallas
kernels in interpret mode and the XLA scan path, on the same numpy
descriptors (the realistic-margin clusters of tests/test_knn_pallas.py).

Tolerances: indices are identical in f32 mode. Distances agree to 5e-5
absolute: ||q||^2 + ||t||^2 is ~128 for these descriptors, so one f32 ulp
of that sum is 1.5e-5 and the two packages' matmuls round in different
orders. bf16 mode is held by match identity (>= 0.99 of ratio-test matches
and top-1 neighbours), the consumer contract of tests/test_knn_pallas.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opencv_dlco_tpu.ops import knn as jax_knn
from opencv_dlco_tpu.ops import knn_pallas as jax_kp

from opencv_dlco_tpu_torch.ops import knn as port_knn
from opencv_dlco_tpu_torch.ops.knn_fused import (
    knn2_fused,
    knn_plain,
    knnk_fused,
)

DIST = dict(rtol=1e-5, atol=5e-5)


@pytest.fixture(scope="module")
def descs():
    rng = np.random.default_rng(11)
    centres = rng.normal(size=(500, 64)).astype(np.float32)
    q = centres[:300] + 0.05 * rng.normal(size=(300, 64)).astype(np.float32)
    t = np.concatenate([centres,
                        rng.normal(size=(900, 64)).astype(np.float32)])
    t = t[rng.permutation(len(t))].astype(np.float32)
    return q, t


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_kernel_f_plain_matches_pallas_f32(descs):
    q, t = descs
    d, i = knn2_fused(_t(q), _t(t), bf16=False)
    d_j, i_j = jax_kp.knn2_fused(jnp.asarray(q), jnp.asarray(t),
                                 interpret=True, bf16=False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), **DIST)


@pytest.mark.parametrize("k", [3, 10])
def test_kernel_h_plain_matches_pallas_f32(descs, k):
    q, t = descs
    d, i = knnk_fused(_t(q), _t(t), k, bf16=False)
    d_j, i_j = jax_kp.knnk_fused(jnp.asarray(q), jnp.asarray(t), k,
                                 interpret=True, bf16=False)
    assert d.shape == i.shape == (q.shape[0], k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), **DIST)
    assert torch.all(d[:, 1:] >= d[:, :-1])


def test_kernel_f_plain_bf16_match_identity(descs):
    q, t = descs
    d, i = knn2_fused(_t(q), _t(t), bf16=True)
    m, _ = port_knn.ratio_test(d, i, ratio=0.9)
    for d_r, i_r in (
            jax_kp.knn2_fused(jnp.asarray(q), jnp.asarray(t), interpret=True,
                              bf16=True),
            jax_knn.knn_match(jnp.asarray(q), jnp.asarray(t), k=2,
                              block=512, fused=False)):
        m_r, _ = jax_knn.ratio_test(d_r, i_r, ratio=0.9)
        assert np.mean(m.numpy() == np.asarray(m_r)) >= 0.99
        assert np.mean(i[:, 0].numpy() == np.asarray(i_r[:, 0])) >= 0.99


def test_kernel_f_plain_padding_edges():
    """Shapes off the tile grid: every query answered, no padding row
    selected (77 x 130 as tests/test_knn_pallas.py)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(77, 32)).astype(np.float32)
    t = rng.normal(size=(130, 32)).astype(np.float32)
    d, i = knn2_fused(_t(q), _t(t), bf16=False)
    d_j, i_j = jax_kp.knn2_fused(jnp.asarray(q), jnp.asarray(t),
                                 interpret=True, bf16=False)
    assert d.shape == i.shape == (77, 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    assert int(i.max()) < 130


def test_kernel_h_plain_empty_slots():
    """Fewer train rows than k: the missing slots are (inf, -1)."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    t = rng.normal(size=(5, 16)).astype(np.float32)
    d, i = knnk_fused(_t(q), _t(t), 8, bf16=False)
    d_j, i_j = jax_kp.knnk_fused(jnp.asarray(q), jnp.asarray(t), 8,
                                 interpret=True, bf16=False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    assert np.all(i[:, 5:].numpy() == -1)
    assert np.all(np.isinf(d[:, 5:].numpy()))


@pytest.mark.parametrize("k", [2, 4])
def test_ties_go_to_the_lowest_train_index(k):
    """Equal distances (duplicate train rows) are ordered by train index,
    as the TPU kernels' masked-min and merge rule order them."""
    rng = np.random.default_rng(8)
    base = rng.normal(size=(6, 8)).astype(np.float32)
    t = np.concatenate([base, base, base])          # each row 3 times
    q = base + 0.01 * rng.normal(size=base.shape).astype(np.float32)
    d, i = knn_plain(_t(q), _t(t), k, bf16=False)
    call = jax_kp.knn2_fused if k == 2 else \
        (lambda a, b, **kw: jax_kp.knnk_fused(a, b, k, **kw))
    _, i_j = call(jnp.asarray(q), jnp.asarray(t), interpret=True, bf16=False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j)[:, :k])
    # the nearest row's three copies, lowest index first
    assert np.all(i[:, 0].numpy() == np.arange(6))
    assert np.all(i[:, 1].numpy() == np.arange(6) + 6)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_knn_match_matches_jax(descs, fused, k):
    q, t = descs
    d, i = port_knn.knn_match(_t(q), _t(t), k=k, block=512, fused=fused,
                              precision="highest")
    d_j, i_j = jax_knn.knn_match(jnp.asarray(q), jnp.asarray(t), k=k,
                                 block=512, fused=False)
    assert d.shape == (q.shape[0], k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), **DIST)


def test_knn_match_auto_takes_the_scan_path_on_cpu(descs):
    q, t = descs
    before = (knn2_fused.launches, knnk_fused.launches)
    d, i = port_knn.knn_match(_t(q), _t(t), k=2)
    d_s, i_s = port_knn.knn_match_scan(_t(q), _t(t), k=2)
    np.testing.assert_array_equal(i.numpy(), i_s.numpy())
    assert (knn2_fused.launches, knnk_fused.launches) == before
    assert not port_knn._fused_eligible(_t(q), _t(t), 2)


def test_ratio_test_and_mutual_nearest_match_jax(descs):
    q, t = descs
    d, i = port_knn.knn_match(_t(q), _t(t), k=2, block=512)
    m, ok = port_knn.ratio_test(d, i, ratio=0.8)
    d_j, i_j = jax_knn.knn_match(jnp.asarray(q), jnp.asarray(t), k=2,
                                 block=512, fused=False)
    m_j, ok_j = jax_knn.ratio_test(d_j, i_j, ratio=0.8)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    for fused in (False, True):
        mm, mok = port_knn.mutual_nearest(_t(q), _t(t), block=512,
                                          fused=fused)
        mm_j, mok_j = jax_knn.mutual_nearest(jnp.asarray(q), jnp.asarray(t),
                                             block=512, fused=False)
        np.testing.assert_array_equal(mm.numpy(), np.asarray(mm_j))
        np.testing.assert_array_equal(mok.numpy(), np.asarray(mok_j))


def test_pairwise_sq_dists_matches_jax(descs):
    q, t = descs
    np.testing.assert_allclose(
        port_knn.pairwise_sq_dists(_t(q[:50]), _t(t[:70])).numpy(),
        np.asarray(jax_knn.pairwise_sq_dists(jnp.asarray(q[:50]),
                                             jnp.asarray(t[:70]))), **DIST)
