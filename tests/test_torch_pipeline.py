"""The port's slice as a whole, held against the JAX package.

Both packages run genpr -> compdist -> run_pr_sweep (2 x 2 grid) -> prlearn
-> prstats -> pr_rank on the same 192-pair synthetic dataset with the
small ring grid (as tests/test_pipeline.py), the port with its draw
functions following the JAX key schedule. Distance matrices, every w
history row, the stats and the ranking must agree within the stated
tolerances. Port-only tests check resume and the device contract.
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from opencv_dlco_tpu.data.store import ArtifactStore as JaxStore
from opencv_dlco_tpu.data.synthetic import synth_patch_pairs as jax_synth
from opencv_dlco_tpu.parallel.sweep import run_pr_sweep as jax_sweep
from opencv_dlco_tpu.pipeline.stages import Workspace as JaxWorkspace
from opencv_dlco_tpu.utils import configs as jcfg

from opencv_dlco_tpu_torch.data.store import ArtifactStore
from opencv_dlco_tpu_torch.data.synthetic import synth_patch_pairs
from opencv_dlco_tpu_torch.parallel.sweep import run_pr_sweep
from opencv_dlco_tpu_torch.pipeline.stages import Workspace
from opencv_dlco_tpu_torch.utils import configs as pcfg
from opencv_dlco_tpu_torch.utils.checkpoint import RunInterrupted

from test_torch_rda import F32, JaxDraws

POOL = dict(patch_size=64, nr=6, nphi=2, nsigma=3)
PR = dict(n_iter=384, log_step=128, batch=32, max_dim=10_000,
          sampling="block", seed=2215)
GRID = dict(mus=(0.005, 0.02), gammas=(0.05, 0.2))
SINGLE = dict(mu=0.01, gamma=0.1, **PR)


def _write_dataset(root, n_pairs=192):
    rng = np.random.default_rng(99)
    p1, p2, labels = synth_patch_pairs(rng, n_pairs=n_pairs)
    n = len(labels)
    indices = np.zeros((n, 4), np.int32)
    indices[:, 0] = np.arange(n)
    indices[:, 2] = np.arange(n) + n
    indices[:, 1] = np.arange(n)
    indices[:, 3] = np.where(labels == 1, np.arange(n), np.arange(n) + n)
    path = os.path.join(root, "dataset", "synth.h5")
    with ArtifactStore(path, "w") as st:
        st.write("Indices", indices)
        st.write("Patches", np.concatenate([p1, p2]), chunk_rows=256)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the slice in both packages once; returns the two workspaces
    with their sweep results, single-run paths, records and rankings."""
    root_p = str(tmp_path_factory.mktemp("port"))
    root_j = str(tmp_path_factory.mktemp("jax"))
    ds_path = _write_dataset(root_p)
    os.makedirs(os.path.join(root_j, "dataset"))
    shutil.copy(ds_path, os.path.join(root_j, "dataset", "synth.h5"))

    wj = JaxWorkspace(root_j, pool_cfg=jcfg.PoolRegionConfig(**POOL),
                      pair_block=64, progress=False)
    wp = Workspace(root_p, pool_cfg=pcfg.PoolRegionConfig(**POOL),
                   pair_block=64, progress=False, device="cpu")
    out = {}
    for tag, ws, cfg, sweep in (("jax", wj, jcfg, jax_sweep),
                                ("port", wp, pcfg, run_pr_sweep)):
        mp = pytest.MonkeyPatch()
        if tag == "port":
            draws = JaxDraws(PR["seed"])
            draws.install(mp)
        ws.genpr()
        dist = ws.compdist("synth")
        res = sweep(ws, "synth", cfg.PRSweepGrid(**GRID),
                    cfg.PRLearnConfig(**PR))
        if tag == "port":
            # prlearn starts its own key from the seed, as JAX's does
            draws.key = jax.random.PRNGKey(PR["seed"])
        single = ws.prlearn("synth", cfg.PRLearnConfig(**SINGLE))
        mp.undo()
        models = sorted(glob.glob(os.path.join(ws.root, "pr-learn",
                                               "*-pr.h5")))
        recs = ws.prstats(models, {"synth": dist})
        out[tag] = dict(ws=ws, dist=dist, sweep=res, single=single,
                        models=models, recs=recs, ranked=ws.pr_rank(recs))
    return out


def _read(path, name):
    with JaxStore(path, "r") as st:
        return st.read(name) if st.exists(name) else None


def test_slice_distances_match(runs):
    for name in ("Label",):
        np.testing.assert_array_equal(_read(runs["port"]["dist"], name),
                                      _read(runs["jax"]["dist"], name))
    d_p = _read(runs["port"]["dist"], "Distance")
    d_j = _read(runs["jax"]["dist"], "Distance")
    assert d_p.shape == d_j.shape == (192, 36)
    np.testing.assert_allclose(d_p, d_j, rtol=1e-4, atol=1e-5)
    # the bank artifact is the same file content
    for name in ("RingParams", "PRParams", "PRFilters"):
        np.testing.assert_array_equal(
            _read(runs["port"]["ws"].genpr(), name),
            _read(runs["jax"]["ws"].genpr(), name))


def test_slice_w_histories_match(runs):
    names_p = [os.path.basename(m) for m in runs["port"]["models"]]
    names_j = [os.path.basename(m) for m in runs["jax"]["models"]]
    assert names_p == names_j and len(names_p) == 5
    for mp, mj in zip(runs["port"]["models"], runs["jax"]["models"]):
        hp, hj = _read(mp, "w"), _read(mj, "w")
        assert (hp is None) == (hj is None)
        if hp is not None:
            assert hp.shape == hj.shape
            np.testing.assert_allclose(hp, hj, **F32)
    for rp, rj in zip(runs["port"]["sweep"], runs["jax"]["sweep"]):
        assert (rp["mu"], rp["gamma"], rp["nnz"]) == \
            (rj["mu"], rj["gamma"], rj["nnz"])
        assert rp["obj"] == pytest.approx(rj["obj"], rel=1e-4)


def test_slice_stats_and_ranking_match(runs):
    rp, rj = runs["port"]["recs"], runs["jax"]["recs"]
    assert len(rp) == len(rj) > 0
    for a, b in zip(rp, rj):
        assert os.path.basename(a["model"]) == os.path.basename(b["model"])
        assert (a["row"], a["dim"], a["n_pr"]) == (b["row"], b["dim"],
                                                   b["n_pr"])
        assert a["fpr95"] == pytest.approx(b["fpr95"], abs=1e-6)
        assert a["auc"] == pytest.approx(b["auc"], abs=1e-5)
    top_p = [(os.path.basename(r["model"]), r["row"])
             for r in runs["port"]["ranked"]]
    top_j = [(os.path.basename(r["model"]), r["row"])
             for r in runs["jax"]["ranked"]]
    assert top_p[0] == top_j[0]
    assert sorted(top_p) == sorted(top_j)


def test_slice_stages_are_idempotent(runs):
    ws = runs["port"]["ws"]
    assert ws.compdist("synth") == runs["port"]["dist"]
    assert ws.prlearn("synth", pcfg.PRLearnConfig(**SINGLE)) == \
        runs["port"]["single"]
    res = run_pr_sweep(ws, "synth", pcfg.PRSweepGrid(**GRID),
                       pcfg.PRLearnConfig(**PR))
    assert sorted(r["model"] for r in res) == \
        sorted(r["model"] for r in runs["port"]["sweep"])


def test_resume_reproduces_uninterrupted_run(runs, tmp_path):
    """prlearn and the sweep stopped after one log period and resumed
    from their checkpoints write the same artifacts as the full runs."""
    root = str(tmp_path)
    for sub in ("dataset", "distances"):
        shutil.copytree(os.path.join(runs["port"]["ws"].root, sub),
                        os.path.join(root, sub))
    ws = Workspace(root, pool_cfg=pcfg.PoolRegionConfig(**POOL),
                   pair_block=64, progress=False, device="cpu")
    ws.genpr()
    cfg = pcfg.PRLearnConfig(**SINGLE)
    with pytest.raises(RunInterrupted):
        ws.prlearn("synth", cfg, _stop_after_logs=1)
    path = ws.prlearn("synth", cfg)
    full = os.path.join(root, "full")
    shutil.copytree(os.path.join(root, "dataset"),
                    os.path.join(full, "dataset"))
    shutil.copytree(os.path.join(root, "distances"),
                    os.path.join(full, "distances"))
    ws_full = Workspace(full, pool_cfg=pcfg.PoolRegionConfig(**POOL),
                        pair_block=64, progress=False, device="cpu")
    np.testing.assert_array_equal(_read(path, "w"),
                                  _read(ws_full.prlearn("synth", cfg), "w"))

    grid, base = pcfg.PRSweepGrid(**GRID), pcfg.PRLearnConfig(**PR)
    with pytest.raises(RunInterrupted):
        run_pr_sweep(ws, "synth", grid, base, _stop_after_logs=2)
    assert os.path.exists(ws.path("pr-learn", "synth-sweep-ckpt.h5"))
    resumed = run_pr_sweep(ws, "synth", grid, base)
    fresh = run_pr_sweep(ws_full, "synth", grid, base)
    assert [r["obj"] for r in resumed] == [r["obj"] for r in fresh]
    for a, b in zip(resumed, fresh):
        wa, wb = _read(a["model"], "w"), _read(b["model"], "w")
        assert (wa is None) == (wb is None)
        if wa is not None:
            np.testing.assert_array_equal(wa, wb)


def test_non_finite_distances_fail_the_block(tmp_path):
    """compdist hard-fails a block with NaN/Inf (src/comp-fulldists.cpp:362)."""
    root = str(tmp_path)
    _write_dataset(root, n_pairs=8)
    ws = Workspace(root, pool_cfg=pcfg.PoolRegionConfig(**POOL),
                   progress=False, device="cpu")
    with ArtifactStore(ws.genpr(), "a") as st:
        f = st.read("PRFilters")
        f[0, 0, 0] = np.nan
        st.write("PRFilters", f)
    with pytest.raises(FloatingPointError):
        ws.compdist("synth")


def test_workspace_cuda_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Workspace(str(tmp_path))


def test_synthetic_pairs_match_jax_copy():
    """The port's numpy pair generator is the JAX package's, draw for draw."""
    kw = dict(noise=0.1, shift=5, rot=0.3, scale_jitter=0.18,
              contrast_jitter=0.35, neg_overlap=0.45)
    a = synth_patch_pairs(np.random.default_rng((3, 0)), n_pairs=6, **kw)
    b = jax_synth(np.random.default_rng((3, 0)), n_pairs=6, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_npy_dir_backend_matches_hdf5(runs, tmp_path, monkeypatch):
    """Without h5py the store keeps each artifact as a directory of .npy
    files; the slice writes the same datasets and values through it,
    resume included."""
    import opencv_dlco_tpu_torch.data.store as store

    root = str(tmp_path)
    monkeypatch.setattr(store, "h5py", None)
    _write_dataset(root)
    assert os.path.isdir(os.path.join(root, "dataset", "synth.h5"))
    ws = Workspace(root, pool_cfg=pcfg.PoolRegionConfig(**POOL),
                   pair_block=64, progress=False, device="cpu")
    JaxDraws(PR["seed"]).install(monkeypatch)
    dist = ws.compdist("synth")
    with ArtifactStore(dist, "r") as st:
        np.testing.assert_array_equal(
            st.read("Distance"), _read(runs["port"]["dist"], "Distance"))
    res = run_pr_sweep(ws, "synth", pcfg.PRSweepGrid(**GRID),
                       pcfg.PRLearnConfig(**PR))
    assert [r["obj"] for r in res] == [r["obj"] for r in runs["port"]["sweep"]]
    JaxDraws(PR["seed"]).install(monkeypatch)
    cfg = pcfg.PRLearnConfig(**SINGLE)
    with pytest.raises(RunInterrupted):
        ws.prlearn("synth", cfg, _stop_after_logs=1)
    path = ws.prlearn("synth", cfg)
    with ArtifactStore(path, "r") as st:
        np.testing.assert_array_equal(
            st.read("w"), _read(runs["port"]["single"], "w"))
        assert st.get_meta("done_iters") == str(PR["n_iter"])
    models = sorted(glob.glob(os.path.join(root, "pr-learn", "*-pr.h5")))
    recs = ws.prstats(models, {"synth": dist})
    assert [(r["fpr95"], r["auc"]) for r in recs] == \
        [(r["fpr95"], r["auc"]) for r in runs["port"]["recs"]]


def test_convert_matches_jax(tmp_path):
    """Stage 1 on a fake Brown directory writes the JAX package's dataset."""
    import cv2

    rng = np.random.default_rng(12)
    d = tmp_path / "brown"
    d.mkdir()
    ids = rng.integers(0, 300, size=(100, 2))
    pts = rng.integers(0, 50, size=(100, 2))
    (d / "m50_500000_500000_0.txt").write_text("\n".join(
        f"{a} {p} 0 {b} {q} 0 0" for (a, b), (p, q) in zip(ids, pts)))
    for i, s in enumerate(rng.integers(0, 255, size=(2, 1024, 1024))):
        cv2.imwrite(str(d / f"patches{i:04d}.bmp"), s.astype(np.uint8))
    out = {}
    for tag, cls, cfg in (("port", Workspace, pcfg), ("jax", JaxWorkspace,
                                                      jcfg)):
        kw = {"device": "cpu"} if tag == "port" else {}
        ws = cls(str(tmp_path / tag), pool_cfg=cfg.PoolRegionConfig(**POOL),
                 progress=False, **kw)
        out[tag] = ws.convert(str(d), "brown", max_pairs=80)
    for name in ("Indices", "Patches"):
        np.testing.assert_array_equal(_read(out["port"], name),
                                      _read(out["jax"], name))
