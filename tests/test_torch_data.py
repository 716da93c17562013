"""The port's data modules held against the JAX package: the numpy
generators of data/synthetic.py (bit-equal), the on-device pair generator
(by distribution), the stage-1 dataset on a CPU workspace (bit-equal), and
the reference-log parser (equal).

``synth_patch_pairs_device`` draws from torch's stream, so it is held by
the JAX suite's own gates (tests/test_data.py:109-140) at 1,024 pairs of
HARD_PAIR_PARAMS, against the numpy route and against the JAX package's
device program run on the CPU: pixel mean within 5%, std within 8%, the
positive / negative mean-abs-difference ratio within 0.1 with positives
below negatives in both, labels equal. Two draws from one seed give the
same bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from opencv_dlco_tpu.data import reference_logs as jax_logs
from opencv_dlco_tpu.data import synthetic as jax_syn
from opencv_dlco_tpu.data.store import ArtifactStore as JaxStore
from opencv_dlco_tpu.pipeline.e2e import (
    generate_synthetic_dataset as jax_generate)
from opencv_dlco_tpu.pipeline.stages import Workspace as JaxWorkspace

from opencv_dlco_tpu_torch import data as pdata
from opencv_dlco_tpu_torch.data import reference_logs, synthetic
from opencv_dlco_tpu_torch.data.store import ArtifactStore
from opencv_dlco_tpu_torch.pipeline.e2e import generate_synthetic_dataset
from opencv_dlco_tpu_torch.pipeline.stages import Workspace

N_GATE = 1024


def test_synth_pj_dataset_bit_equal_to_jax():
    assert pdata.synth_pj_dataset is synthetic.synth_pj_dataset
    for kw in ({}, dict(n_pos=300, n_neg=200, n_feat=48, n_subspace=5,
                        sep=1.0)):
        ours = synthetic.synth_pj_dataset(np.random.default_rng(5), **kw)
        ref = jax_syn.synth_pj_dataset(np.random.default_rng(5), **kw)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_brown_like_pr_splits_bit_equal_to_jax():
    assert synthetic.BROWN_RING_PARAMS == jax_syn.BROWN_RING_PARAMS
    for params in (None, dict(n_feat=256, n_info=8, decay=-0.6)):
        ours = synthetic.brown_like_pr_splits(np.random.default_rng(9), 200,
                                              100, params)
        ref = jax_syn.brown_like_pr_splits(np.random.default_rng(9), 200,
                                           100, params)
        for a, b in zip(ours, ref):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def _stats(p1, p2, labels):
    d = np.abs(p1.astype(np.float32) - p2.astype(np.float32))
    pos = d[labels == 1].mean()
    neg = d[labels == 0].mean()
    return p1.mean(), p1.std(), pos, neg


def _gates(ref, got):
    """tests/test_data.py:109-140's gates of ``got`` against ``ref``."""
    (a1, a2, la), (b1, b2, lb) = ref, got
    assert b1.shape == a1.shape and b2.shape == a2.shape
    assert b1.dtype == np.uint8 and b2.dtype == np.uint8
    np.testing.assert_array_equal(la, lb)
    am, asd, apos, aneg = _stats(a1, a2, la)
    bm, bsd, bpos, bneg = _stats(b1, b2, lb)
    assert abs(am - bm) < 0.05 * am, (am, bm)
    assert abs(asd - bsd) < 0.08 * asd, (asd, bsd)
    assert apos < aneg and bpos < bneg
    assert abs(apos / aneg - bpos / bneg) < 0.1, (apos / aneg, bpos / bneg)


@pytest.fixture(scope="module")
def device_draw():
    g = torch.Generator().manual_seed(7)
    return synthetic.synth_patch_pairs_device(
        N_GATE, generator=g, device="cpu", **synthetic.HARD_PAIR_PARAMS)


def test_device_generator_matches_numpy_route(device_draw):
    ref = synthetic.synth_patch_pairs(np.random.default_rng(7),
                                      n_pairs=N_GATE,
                                      **synthetic.HARD_PAIR_PARAMS)
    _gates(ref, device_draw)


def test_device_generator_matches_jax_device_program(device_draw):
    ref = jax_syn.synth_patch_pairs_device(jax.random.PRNGKey(7),
                                           n_pairs=N_GATE,
                                           **jax_syn.HARD_PAIR_PARAMS)
    _gates(ref, device_draw)


def test_device_generator_same_seed_same_bits(device_draw):
    again = synthetic.synth_patch_pairs_device(
        N_GATE, generator=torch.Generator().manual_seed(7), device="cpu",
        **synthetic.HARD_PAIR_PARAMS)
    for a, b in zip(device_draw, again):
        np.testing.assert_array_equal(a, b)
    other = synthetic.synth_patch_pairs_device(
        N_GATE, generator=torch.Generator().manual_seed(8), device="cpu",
        **synthetic.HARD_PAIR_PARAMS)
    assert not np.array_equal(device_draw[0], other[0])


def test_device_texture_matches_numpy_on_the_same_normals():
    """_smooth_device on the numpy route's own normal draws: the same band-
    limited textures up to f32 FFT rounding (abs 1e-5 on [0, 1] images)."""
    n, size = 6, 40
    rng = np.random.default_rng(2)
    draws = iter([rng.normal(size=(n, size, size)),
                  rng.normal(size=(n, size, size))])
    ours = synthetic._smooth_device(
        lambda shape: torch.from_numpy(next(draws).astype(np.float32)),
        n, size, torch.device("cpu"))
    ref = jax_syn._smooth(np.random.default_rng(2), n, size)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


def test_device_warp_matches_numpy_warp():
    """_warp_device against the numpy route's _warp_bilinear on the same
    images and warps, at HARD_PAIR_PARAMS' extremes (shift 5, rotation
    0.3, scale 1.18^+-1): every tap stays inside the base, the (h - 2)
    clamp and the [0, 1] fraction clamp as in the reference; abs 1e-4
    (f32 coordinates against f64)."""
    rng = np.random.default_rng(5)
    p = synthetic.HARD_PAIR_PARAMS
    margin = p["shift"] + int(np.ceil(32 * (np.sin(p["rot"])
                                            + p["scale_jitter"]))) + 1
    imgs = rng.uniform(0, 1, (8, 64 + 2 * margin, 64 + 2 * margin))
    sh, r, sj = p["shift"], p["rot"], np.log1p(p["scale_jitter"])
    dy = np.array([sh, -sh, sh, -sh, 0, 0, 1.3, -2.7])
    dx = np.array([sh, -sh, -sh, sh, 0, 0, -0.4, 4.9])
    ang = np.array([r, -r, r, -r, 0, 0, 0.1, -0.29])
    sc = np.exp(np.array([sj, -sj, -sj, sj, 0, 0, 0.05, -0.1]))
    ref = jax_syn._warp_bilinear(imgs, dy, dx, ang, sc, 64)
    t32 = [torch.from_numpy(np.asarray(a, np.float32))
           for a in (dy, dx, ang, sc)]
    ours = synthetic._warp_device(
        torch.from_numpy(imgs.astype(np.float32)), *t32, 64)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)
    # identity warps are the static centre crop
    np.testing.assert_array_equal(
        ours[4:6].numpy(),
        imgs[4:6, margin:margin + 64, margin:margin + 64].astype(np.float32))


def test_generate_synthetic_dataset_cpu_route_bit_equal_to_jax(tmp_path):
    """A CPU workspace takes the numpy route for every chunk, the tail
    included: the same Indices and Patches as the JAX package's numpy
    route, and the same generator metadata."""
    wj = JaxWorkspace(str(tmp_path / "jax"), progress=False)
    wp = Workspace(str(tmp_path / "port"), progress=False, device="cpu")
    kw = dict(n_pairs=40, chunk=16)
    out_j = jax_generate(wj, "syn", seed=11, **kw)
    out_p = generate_synthetic_dataset(wp, "syn", seed=11, **kw)
    with JaxStore(out_j, "r") as sj, ArtifactStore(out_p, "r") as sp:
        for name in ("Indices", "Patches"):
            np.testing.assert_array_equal(sp.read(name), sj.read(name))
        assert sp.get_meta("generator") == sj.get_meta("generator")
        assert sp.get_meta("complete") and sj.get_meta("complete")
    # idempotent: a complete dataset is kept
    assert generate_synthetic_dataset(wp, "syn", seed=11, **kw) == out_p


def _write_log(path, steps, stats):
    lines = ["pr-learn: liberty mu=0.01 gamma=0.05", ""]
    for i, (t, loss, reg, obj, best, nnz, bnnz) in enumerate(steps):
        tag = "Best" if i % 2 else "Step"
        lines.append(f"{tag}: {t}  Loss: {loss} Regul: {reg} Obj: {obj} "
                     f"({best})  NNZ: {nnz} ({bnnz})")
    for n_pr, dup, dim, max_dim, auc, fpr in stats:
        lines.append(f"Stat: nPR #{n_pr} (#{dup}) Dim/MaxDim "
                     f"[{dim}/{max_dim}] AUC: {auc} FPR95: {fpr}")
    lines.append("noise line that matches neither pattern")
    path.write_text("\n".join(lines) + "\n")


def test_reference_log_parser_equal_to_jax(tmp_path):
    assert reference_logs.REFERENCE_PR_LOGS.endswith(
        "workspace/pr-learn/logging")
    rng = np.random.default_rng(4)
    for mu, gamma, done in (("0.01", "0.05", 50_000_000),
                            ("0.001", "0.25", 3_100_000),
                            ("0.06", "0.005", 0)):
        n = 0 if done == 0 else 4
        steps = [(done - (n - 1 - i) * 100_000,
                  *np.round(rng.uniform(0, 2, 4), 6).tolist(),
                  int(rng.integers(50, 900)), int(rng.integers(50, 900)))
                 for i in range(n)]
        stats = [(int(rng.integers(50, 90)), int(rng.integers(90, 99)),
                  int(rng.integers(400, 700)), 640,
                  *np.round(rng.uniform(0, 1, 2), 5).tolist())
                 for _ in range(2)]
        _write_log(tmp_path / f"liberty-{mu}-{gamma}-pr.log", steps, stats)
    (tmp_path / "notredame-0.01-0.05-pr.log").write_text("")
    ours = reference_logs.pr_log_grid("liberty", str(tmp_path))
    ref = jax_logs.pr_log_grid("liberty", str(tmp_path))
    assert sorted(ours) == sorted(ref) == [(0.001, 0.25), (0.01, 0.05),
                                           (0.06, 0.005)]
    for key, run in ours.items():
        assert dataclasses.asdict(run) == dataclasses.asdict(ref[key])
        for prop in ("final_best_obj", "final_best_nnz", "final_stat",
                     "completed"):
            assert getattr(run, prop) == getattr(ref[key], prop)
    assert ours[(0.01, 0.05)].completed
    assert not ours[(0.001, 0.25)].completed
    assert ours[(0.06, 0.005)].final_best_nnz is None
    with pytest.raises(ValueError):
        reference_logs.parse_pr_learn_log(str(tmp_path / "x.log"))
