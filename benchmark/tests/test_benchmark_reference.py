"""The plain reference against the port, at toy sizes on the CPU."""

import numpy as np
import torch

from benchmark.inputs import patch_pairs, pj_splits
from benchmark.inputs.patch_pairs import seed_of
from benchmark.reference import pj as ref_pj
from benchmark.reference import stage3 as ref_s3
from benchmark.tests.conftest import toy


def test_bank_matches_the_port():
    from opencv_dlco_tpu_torch.ops.pool_regions import build_filter_bank
    from opencv_dlco_tpu_torch.utils.configs import PoolRegionConfig

    pool = dict(patch_size=64, nr=6, nphi=5, nsigma=4, n_symmetries=8)
    _, _, want = build_filter_bank(PoolRegionConfig(**pool))
    got = ref_s3.bank(pool, "cpu").numpy()
    assert got.shape == want.shape == (6 * 5 * 4 * 8, 4096)
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-12)


def test_transform_and_rows_match_the_port():
    from opencv_dlco_tpu_torch.ops.pair_distance import ring_distances
    from opencv_dlco_tpu_torch.ops.patch_transform import \
        batch_patch_transform
    from opencv_dlco_tpu_torch.ops.pool_regions import build_filter_bank
    from opencv_dlco_tpu_torch.utils.configs import (DescriptorConfig,
                                                     PoolRegionConfig)

    cfg = toy("m50_f32.compdist")["config"]
    patches, idx = patch_pairs.make(32, 5, 16, "cpu")
    p = torch.from_numpy(patches[:24])
    desc = DescriptorConfig(**cfg["descriptor"])
    assert torch.equal(ref_s3.transform(p, cfg["descriptor"]),
                       batch_patch_transform(p, desc))
    _, _, bank = build_filter_bank(PoolRegionConfig(**cfg["pool_regions"]))
    bank = torch.from_numpy(bank)
    pairs = np.array([1, 5, 17, 30])
    got = ref_s3.rows(cfg, patches, idx, pairs, "cpu")
    # the port's rows, block by block as stage 3 computes them
    want = []
    for lo in (0, 16):
        pt = [batch_patch_transform(torch.from_numpy(
            patches[idx[lo:lo + 16, c]]), desc) for c in (0, 2)]
        want.append(ring_distances(bank, *pt))
    want = torch.cat(want)[torch.from_numpy(pairs)]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_pj_first_steps_match_the_port():
    from opencv_dlco_tpu_torch.models import pj_rda

    cfg = toy("m50_f32.pjgrid")["config"]
    pj = cfg["pj"]
    combos = [(m, g) for m in pj["mus"] for g in pj["gammas"]]
    splits = pj_splits.make(16, 96, 40, 0.1, 0.3, 7, "cpu")
    mus = torch.tensor([c[0] for c in combos])
    gammas = torch.tensor([c[1] for c in combos])
    gen = torch.Generator().manual_seed(seed_of(7, 3))
    st = pj_rda.pj_init_batch(16, len(combos), None, device="cpu")
    got = []
    for n in (1, 2):
        st = pj_rda.pj_train_chunk_batch(
            splits["pos_trn"], splits["neg_trn"], mus, gammas, st, gen,
            batch=pj["batch"], n_steps=n, eigh_mode="psd_ns",
            ns_iters=pj["ns_iters"])
        got.append((st, pj_rda.pj_validate(splits["pos_val"],
                                           splits["neg_val"], mus, st)))
    ref = ref_pj.follow(splits, combos,
                        torch.Generator().manual_seed(seed_of(7, 3)),
                        [1, 2], pj["batch"], pj["ns_iters"])
    for (st, (loss, regul, obj, _)), r in zip(got, ref):
        assert st.t == r["t"]
        torch.testing.assert_close(st.df_avg, r["df_avg"], rtol=1e-5,
                                   atol=1e-7)
        torch.testing.assert_close(st.a, r["a"], rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(obj.double(), r["obj"], rtol=1e-5,
                                   atol=1e-8)


def test_window_objective_matches_the_port():
    from opencv_dlco_tpu_torch.models import pj_rda

    cfg = toy("m50_f32.pjgrid")["config"]
    pj = cfg["pj"]
    combos = [(m, g) for m in pj["mus"] for g in pj["gammas"]]
    splits = pj_splits.make(16, 96, 40, 0.1, 0.3, 11, "cpu")
    mus = torch.tensor([c[0] for c in combos])
    gammas = torch.tensor([c[1] for c in combos])
    st = pj_rda.pj_init_batch(16, len(combos), None, device="cpu")
    st = pj_rda.pj_train_chunk_batch(
        splits["pos_trn"], splits["neg_trn"], mus, gammas, st,
        torch.Generator().manual_seed(5), batch=pj["batch"], n_steps=7,
        eigh_mode="psd_ns", ns_iters=pj["ns_iters"])
    obj = pj_rda.pj_validate(splits["pos_val"], splits["neg_val"], mus,
                             st)[2]
    got = ref_pj.window_objective(splits, combos, st.w)
    assert got.dtype == torch.float64 and bool((got > 0).all())
    torch.testing.assert_close(obj.double(), got, rtol=1e-5, atol=1e-8)


def test_inputs_repeat_for_a_seed():
    a = patch_pairs.make(16, 2 ** 31 + 11, 16, "cpu")
    b = patch_pairs.make(16, 2 ** 31 + 11, 16, "cpu")
    c = patch_pairs.make(16, 2 ** 31 + 12, 16, "cpu")
    assert np.array_equal(a[0], b[0]) and not np.array_equal(a[0], c[0])
    assert a[0].dtype == np.uint8 and a[0].shape == (32, 64, 64)
    # positives first: pair i's two patches share the point id
    assert (a[1][:8, 1] == a[1][:8, 3]).all()
    assert (a[1][8:, 1] != a[1][8:, 3]).all()
    s1 = pj_splits.make(8, 20, 10, 0.1, 0.3, 3, "cpu")
    s2 = pj_splits.make(8, 20, 10, 0.1, 0.3, 3, "cpu")
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert s1["neg_trn"].std() > 2 * s1["pos_trn"].std()
