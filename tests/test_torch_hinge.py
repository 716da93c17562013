"""The plain version of kernel E (blockwise hinge) and the port's hinge
dispatcher, held against the JAX package: the Pallas kernel in interpret
mode and the sorted form, on the same numpy inputs.

Tolerance: the all-pairs sum adds P x N f32 terms in a different order in
each implementation, so totals agree to a relative 1e-5 (a few hundred
f32 roundings of a sum of ~1e6 terms); per-positive partial sums of at
most 2,500 terms agree to 1e-5 relative as well.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opencv_dlco_tpu.ops import hinge as jax_hinge

from opencv_dlco_tpu_torch.ops.hinge import (
    hinge_partials,
    hinge_partials_plain,
    hinge_sum,
    hinge_sum_blockwise,
    hinge_sum_sorted,
)

REL = 1e-5


def _draw(n_pos, n_neg, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(1.0, 0.6, n_pos).astype(np.float32),
            rng.normal(2.0, 0.8, n_neg).astype(np.float32))


# ragged against the TPU kernel's 512 x 2048 tiles on both sides, and exact
@pytest.mark.parametrize("n_pos,n_neg", [(700, 2500), (512, 2048), (3, 5)])
def test_kernel_e_plain_matches_pallas_and_sorted(n_pos, n_neg):
    pos, neg = _draw(n_pos, n_neg, seed=n_pos)
    ours = float(hinge_sum_blockwise(torch.from_numpy(pos),
                                     torch.from_numpy(neg)))
    pallas = float(jax_hinge.hinge_sum_blockwise(
        jnp.asarray(pos), jnp.asarray(neg), interpret=True))
    sorted_ = float(jax_hinge.hinge_sum_sorted(jnp.asarray(pos),
                                               jnp.asarray(neg)))
    assert ours == pytest.approx(pallas, rel=REL)
    assert ours == pytest.approx(sorted_, rel=REL)
    # the port's own sorted form agrees too
    assert float(hinge_sum_sorted(torch.from_numpy(pos),
                                  torch.from_numpy(neg))) == \
        pytest.approx(sorted_, rel=REL)


def test_kernel_e_partials_are_per_positive_sums():
    """Per-positive sums against a float64 transcription of the
    reference's kSubtractVectorsByRows inner loop."""
    pos, neg = _draw(37, 4100, seed=5)
    ours = hinge_partials_plain(torch.from_numpy(pos),
                                torch.from_numpy(neg)).numpy()
    ref = np.maximum(pos.astype(np.float64)[:, None] + 1.0
                     - neg.astype(np.float64)[None, :], 0.0).sum(axis=1)
    np.testing.assert_allclose(ours, ref, rtol=REL)


def test_hinge_dispatcher():
    pos, neg = _draw(100, 300, seed=9)
    p, n = torch.from_numpy(pos), torch.from_numpy(neg)
    a = float(hinge_sum(p, n))
    b = float(hinge_sum(p, n, method="blockwise"))
    assert a == pytest.approx(b, rel=REL)
    assert a == pytest.approx(float(jax_hinge.hinge_sum(
        jnp.asarray(pos), jnp.asarray(neg), method="blockwise")), rel=REL)
    with pytest.raises(ValueError):
        hinge_sum(p, n, method="dense")


def test_kernel_e_counts_no_launch_on_cpu():
    before = hinge_sum_blockwise.launches
    hinge_sum_blockwise(torch.ones(4), torch.ones(4))
    assert hinge_sum_blockwise.launches == before


def test_kernel_e_partials_and_empty_sides_on_cpu():
    """On CPU tensors the partials are the plain version's; no positives
    sum to 0 and no negatives give zero partials, as the kernel's edges."""
    pos, neg = _draw(50, 300, seed=2)
    p, n = torch.from_numpy(pos), torch.from_numpy(neg)
    assert torch.equal(hinge_partials(p, n), hinge_partials_plain(p, n))
    assert float(hinge_sum_blockwise(torch.zeros(0), n)) == 0.0
    assert torch.equal(hinge_partials(p, torch.zeros(0)), torch.zeros(50))


def _kernel_e_order(pos, neg, n_slices, doubled):
    """Kernel E's summation order in f32 (csrc/hinge.cu): negatives cut in
    ``n_slices`` slices of whole float4s; per slice, each float4's four
    terms added in pairs, then to the accumulator, with the rest of the
    last slice (< 4) added one by one; the slices' partials added in slice
    order. ``doubled``: the kernel's x + |x| = 2 max(0, x) form, halved at
    the end of each slice."""
    th = pos + np.float32(1.0)
    n = neg.shape[0]
    slice_ = 4 * -(-(-(-n // n_slices)) // 4)

    def term(x):
        return x + np.abs(x) if doubled else np.maximum(x, np.float32(0.0))

    total = np.zeros_like(th)
    for k in range(n_slices):
        seg = neg[min(k * slice_, n):min((k + 1) * slice_, n)]
        acc = np.zeros_like(th)
        n4 = seg.shape[0] // 4 * 4
        for q in range(0, n4, 4):
            a, b, c, d = (term(th - seg[q + e]) for e in range(4))
            acc = acc + ((a + b) + (c + d))
        for q in range(n4, seg.shape[0]):
            acc = acc + term(th - seg[q])
        total = total + (np.float32(0.5) * acc if doubled else acc)
    return total


@pytest.mark.parametrize("n_pos,n_neg,n_slices", [(700, 2503, 3),
                                                  (5, 1030, 1), (9, 6, 4)])
def test_kernel_e_summation_order_emulation(n_pos, n_neg, n_slices):
    """The kernel's order, emulated: the doubled form carries the same bits
    as the max form, and both agree with the plain version and the Pallas
    kernel (interpret mode) to rel 1e-5, per positive and in total."""
    pos, neg = _draw(n_pos, n_neg, seed=n_neg)
    doubled = _kernel_e_order(pos, neg, n_slices, doubled=True)
    plain_max = _kernel_e_order(pos, neg, n_slices, doubled=False)
    assert doubled.dtype == np.float32
    np.testing.assert_array_equal(doubled, plain_max)
    ref = hinge_partials_plain(torch.from_numpy(pos),
                               torch.from_numpy(neg)).numpy()
    np.testing.assert_allclose(doubled, ref, rtol=REL)
    pallas = float(jax_hinge.hinge_sum_blockwise(
        jnp.asarray(pos), jnp.asarray(neg), interpret=True))
    assert float(doubled.sum()) == pytest.approx(pallas, rel=REL)
