"""The exported descriptor's evaluation in the port, held against the JAX
package: VGGDescriptor on the same header, the verification / matching /
retrieval protocols on the same descriptors, and the HPatches loader and
harness on a patch tree the test writes.

Tolerances: descriptors to rtol 1e-5 of their largest magnitude (the same
f32 products, TF32 off, in other orders); protocol metrics to 1e-6 (ROC
areas and ranks of the same orderings).
"""

import os

import numpy as np
import pytest
import torch

from opencv_dlco_tpu.data import hpatches as jax_hp
from opencv_dlco_tpu.data.synthetic import _smooth, synth_patch_pairs
from opencv_dlco_tpu.models.vgg import VGGDescriptor as JaxVGG
from opencv_dlco_tpu.pipeline import eval as jax_eval
from opencv_dlco_tpu.pipeline.export import emit_vgg_header as jax_emit

from opencv_dlco_tpu_torch.data import hpatches as port_hp
from opencv_dlco_tpu_torch.models import vgg as vgg_mod
from opencv_dlco_tpu_torch.models.vgg import VGGDescriptor
from opencv_dlco_tpu_torch.ops.pool_regions import build_filter_bank
from opencv_dlco_tpu_torch.pipeline import eval as port_eval
from opencv_dlco_tpu_torch.pipeline.export import emit_vgg_header
from opencv_dlco_tpu_torch.utils.configs import PoolRegionConfig

REL = 1e-5


@pytest.fixture(scope="module")
def header():
    """A header from real bank rows (the small ring grid) and a random
    32 x 96 projection, as the exporter writes it."""
    rng = np.random.default_rng(31)
    _, _, bank = build_filter_bank(PoolRegionConfig(nr=6, nphi=2, nsigma=3))
    sel = bank[rng.choice(bank.shape[0], 12, replace=False)].astype(
        np.float32)
    pj = (rng.standard_normal((32, 96)) * 0.2).astype(np.float32)
    text = emit_vgg_header(sel, pj, pr_source="pr.h5", pj_source="pj.h5")
    assert text == jax_emit(sel, pj, pr_source="pr.h5", pj_source="pj.h5")
    return text


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(32)
    return synth_patch_pairs(rng, n_pairs=48, noise=0.04)


def test_vgg_forward_matches_jax_describe(header, pairs, monkeypatch):
    p1, _, _ = pairs
    ours = VGGDescriptor.from_header(header, device="cpu")
    ref = JaxVGG.from_header(header)
    assert ours.n_dim == ref.n_dim == 32
    np.testing.assert_array_equal(ours.sel_filters.numpy(), ref.sel_filters)
    np.testing.assert_array_equal(ours.projection.numpy(), ref.projection)
    d = ours(torch.from_numpy(p1)).numpy()
    d_ref = np.asarray(ref.describe(p1))
    assert d.shape == (48, 32)
    np.testing.assert_allclose(d, d_ref, atol=REL * np.abs(d_ref).max())
    # describe: numpy in, blocks of patches, the model's device out
    monkeypatch.setattr(vgg_mod, "DESCRIBE_BLOCK", 20)
    np.testing.assert_array_equal(ours.describe(p1).numpy(), d)
    assert isinstance(ours, torch.nn.Module)
    assert {n for n, _ in ours.named_buffers()} == {"sel_filters",
                                                   "projection"}


def test_vgg_from_artifacts_matches_header(tmp_path, header):
    """from_artifacts (filters.h5 + pr#row + pj) builds what the header
    holds."""
    from opencv_dlco_tpu_torch.data.store import ArtifactStore
    from opencv_dlco_tpu_torch.pipeline.export import parse_vgg_header

    cfg = PoolRegionConfig(nr=6, nphi=2, nsigma=3)
    rings, params, bank = build_filter_bank(cfg)
    w = np.zeros(cfg.n_rings, np.float32)
    w[[3, 17]] = 1.0
    with ArtifactStore(str(tmp_path / "filters.h5"), "w") as st:
        st.write("PRFilters", bank.reshape(-1, 64, 64))
    with ArtifactStore(str(tmp_path / "pr.h5"), "w") as st:
        st.append_row("w", w)
    from opencv_dlco_tpu_torch.models.select import select_pr_filters
    n_in = select_pr_filters(bank, w).shape[0] * 8
    pj = np.random.default_rng(1).standard_normal((8, n_in)).astype(
        np.float32)
    with ArtifactStore(str(tmp_path / "pj.h5"), "w") as st:
        st.write("W", pj)
    model = VGGDescriptor.from_artifacts(str(tmp_path / "filters.h5"),
                                         str(tmp_path / "pr.h5") + "#0",
                                         str(tmp_path / "pj.h5"),
                                         device="cpu")
    mats = parse_vgg_header(emit_vgg_header(select_pr_filters(bank, w), pj))
    np.testing.assert_array_equal(model.sel_filters.numpy(), mats["PR"])
    np.testing.assert_array_equal(model.projection.numpy(), mats["PJ"])


def test_vgg_on_cuda_without_card_raises(header, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VGGDescriptor.from_header(header)


def test_verification_and_evaluate_descriptor_match_jax(header, pairs):
    p1, p2, labels = pairs
    ours = port_eval.evaluate_descriptor(
        VGGDescriptor.from_header(header, device="cpu"), (p1, p2), labels)
    ref = jax_eval.evaluate_descriptor(JaxVGG.from_header(header),
                                       (p1, p2), labels)
    assert ours == pytest.approx(ref, abs=1e-6)
    rng = np.random.default_rng(3)
    a = rng.normal(size=(200, 16)).astype(np.float32)
    b = (a + rng.normal(0, 0.7, a.shape)).astype(np.float32)
    lab = (rng.random(200) < 0.5).astype(np.int32)
    b[lab == 0] = rng.normal(size=(int((lab == 0).sum()), 16))
    assert port_eval.verification(a, b, lab) == pytest.approx(
        jax_eval.verification(a, b, lab), abs=1e-6)


@pytest.mark.parametrize("k", [1, 4, 10])
def test_matching_map_matches_jax(k):
    rng = np.random.default_rng(40 + k)
    train = rng.normal(size=(120, 24)).astype(np.float32)
    query = (train[:90] + rng.normal(0, 0.6, (90, 24))).astype(np.float32)
    gt = np.arange(90, dtype=np.int32)
    gt[::7] = -1
    ours = port_eval.matching_map(query, train, gt, k=k)
    ref = jax_eval.matching_map(query, train, gt, k=k)
    assert ours["n_queries"] == ref["n_queries"]
    assert ours["map"] == pytest.approx(ref["map"], abs=1e-6)
    assert ours["precision_at_1"] == pytest.approx(ref["precision_at_1"],
                                                   abs=1e-6)


def test_matching_map_hand_computed():
    """The JAX suite's hand-computed case (tests/test_eval.py)."""
    train = np.eye(4, dtype=np.float32) * 2
    query = np.stack([train[0] + 0.01, train[2] + 0.02, train[3]])
    out = port_eval.matching_map(query, train, np.array([0, 1, -1]), k=4)
    assert out["n_queries"] == 2
    assert 0.5 <= out["map"] <= 1.0
    assert out["precision_at_1"] == 0.5


def test_retrieval_map_matches_jax():
    rng = np.random.default_rng(5)
    centroids = rng.normal(size=(6, 8)).astype(np.float32) * 2
    gallery = (np.repeat(centroids, 4, axis=0)
               + rng.normal(0, 1.0, (24, 8))).astype(np.float32)
    g_labels = np.repeat(np.arange(6), 4)
    for gl in (g_labels, rng.permutation(g_labels)):
        ours = port_eval.retrieval_map(centroids, gallery, np.arange(6), gl)
        ref = jax_eval.retrieval_map(centroids, gallery, np.arange(6), gl)
        assert ours["n_queries"] == ref["n_queries"] == 6
        assert ours["map"] == pytest.approx(ref["map"], abs=1e-6)


def _make_tree(root, n_seq=2, k=12):
    """A patch tree in the HPatches release layout (tall 65-px PNG
    stacks), warped stacks shifted + noised copies of the reference."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(17)
    pad = 4
    for s in range(n_seq):
        seq = root / (("i_" if s % 2 else "v_") + f"seq{s}")
        seq.mkdir(parents=True)
        base = _smooth(rng, k, 65 + 2 * pad)
        for name, amp in (("ref", 0), ("e1", 1), ("e2", 2), ("h1", 3)):
            dy, dx = rng.integers(-amp, amp + 1, size=2)
            out = base[:, pad + dy:pad + dy + 65, pad + dx:pad + dx + 65]
            out = out + rng.normal(0, 0.02 * amp, out.shape)
            stack = (np.clip(out, 0, 1) * 255).astype(np.uint8)
            assert cv2.imwrite(str(seq / f"{name}.png"), stack.reshape(-1, 65))
    return root


def test_hpatches_loader_and_evaluate_match_jax(tmp_path, header):
    root = _make_tree(tmp_path)
    seqs = port_hp.load_benchmark(str(root))
    seqs_j = jax_hp.load_benchmark(str(root))
    assert [s.name for s in seqs] == [s.name for s in seqs_j]
    for a, b in zip(seqs, seqs_j):
        np.testing.assert_array_equal(a.ref, b.ref)
        for d in port_hp.DIFFICULTIES:
            assert len(a.warped[d]) == len(b.warped[d])
            for x, y in zip(a.warped[d], b.warped[d]):
                np.testing.assert_array_equal(x, y)
        p1, p2 = a.pairs("e")
        assert p1.shape == p2.shape == (24, 64, 64)
    model = VGGDescriptor.from_header(header, device="cpu")
    ours = port_hp.evaluate(model.describe, seqs)
    ref = jax_hp.evaluate(JaxVGG.from_header(header).describe, seqs_j)
    assert ours["n_evals"] == ref["n_evals"] == 4
    for key in ("fpr95", "auc", "matching_map"):
        assert ours[key] == pytest.approx(ref[key], abs=1e-6), key
    assert not os.path.exists(str(root / "missing"))
    with pytest.raises(FileNotFoundError):
        port_hp.load_benchmark(str(root / "missing"))
