"""Stages 7-11 of the port as a whole, held against the JAX package.

Both packages run ``Workspace.run_full`` (genpr -> compdist -> PR sweep ->
prstats/rank -> compunproj -> PJ sweep -> pjstats -> pj_rank_cross ->
export) on the slice-1 toy workspace (192 synthetic pairs, the small ring
grid of tests/test_torch_pipeline.py), the port with its draw functions
following the JAX key schedules. The PR grid is one mu at two gammas, large
enough that the winner keeps few rings, so the PJ stage learns on diffs at
most 128 wide. Port-only tests check idempotence, resume and the hard failures.

Tolerances: the unprojected diffs to rtol 1e-4, atol 1e-5 (f32 pooling
products in other orders; a diff of two truncated pooled values <= 1
carries their absolute rounding, as stage 3's distances do); PJ statistics to 1e-5 (ROC areas of the same ordering);
A to 1e-4 of its largest entry (f32 products and an eigendecomposition).
"""

import os
import shutil

import numpy as np
import pytest
from opencv_dlco_tpu.data.store import ArtifactStore as JaxStore
from opencv_dlco_tpu.pipeline.stages import Workspace as JaxWorkspace
from opencv_dlco_tpu.utils import configs as jcfg

import opencv_dlco_tpu_torch.models.pj_rda as port_pj
import opencv_dlco_tpu_torch.models.pr_rda as port_pr
from opencv_dlco_tpu_torch.data.store import ArtifactStore
from opencv_dlco_tpu_torch.models.vgg import VGGDescriptor
from opencv_dlco_tpu_torch.parallel.sweep import run_pj_sweep
from opencv_dlco_tpu_torch.pipeline.export import (
    export_opencv,
    parse_vgg_header,
)
from opencv_dlco_tpu_torch.pipeline.stages import Workspace
from opencv_dlco_tpu_torch.utils import configs as pcfg
from opencv_dlco_tpu_torch.utils.checkpoint import RunInterrupted

from test_torch_pipeline import POOL, _write_dataset
from test_torch_rda import JaxDraws

PR = dict(n_iter=384, log_step=128, batch=32, max_dim=10_000,
          sampling="block", seed=2215)
PR_GRID = dict(mus=(3.5,), gammas=(0.05, 1.0))
PJ = dict(n_iter=20, log_step=10, batch=32, eigh_mode="psd_ns", seed=2215)
PJ_GRID = dict(mus=(0.001, 0.003), gammas=(0.25, 1.0))
PJ_SINGLE = dict(mu=0.002, gamma=0.5, n_iter=20, log_step=10, batch=32,
                 seed=2215)
DIMS = (48, 64)
REL = 1e-4


def _ws(cls, root, cfg, **kw):
    return cls(root, pool_cfg=cfg.PoolRegionConfig(**POOL), pair_block=64,
               progress=False, **kw)


def _install_jax_draws(mp, pr_seed, pj_seed):
    """The port draws what the JAX run_full draws: one key chain for the
    PR sweep and a fresh one for each PJ run, as the JAX stages start
    their own PRNGKey(seed)."""
    pr, pj = JaxDraws(pr_seed), JaxDraws(pj_seed)
    mp.setattr(port_pr, "draw_block_offsets", pr.block_offsets)
    mp.setattr(port_pj, "draw_gather_rows", pj.gather_rows)
    mp.setattr(port_pj, "draw_sweep_rows", pj.sweep_rows)


def _run(ws, cfg):
    return ws.run_full(["synth"], pr_cfg=cfg.PRLearnConfig(**PR),
                       pj_cfg=cfg.PJLearnConfig(**PJ),
                       pr_grid=cfg.PRSweepGrid(**PR_GRID),
                       pj_grid=cfg.PJSweepGrid(**PJ_GRID), export_dims=DIMS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root_p = str(tmp_path_factory.mktemp("port"))
    root_j = str(tmp_path_factory.mktemp("jax"))
    ds_path = _write_dataset(root_p)
    os.makedirs(os.path.join(root_j, "dataset"))
    shutil.copy(ds_path, os.path.join(root_j, "dataset", "synth.h5"))
    out = {}
    wj = _ws(JaxWorkspace, root_j, jcfg)
    out["jax"] = dict(ws=wj, res=_run(wj, jcfg))
    wp = _ws(Workspace, root_p, pcfg, device="cpu")
    mp = pytest.MonkeyPatch()
    _install_jax_draws(mp, PR["seed"], PJ["seed"])
    out["port"] = dict(ws=wp, res=_run(wp, pcfg))
    mp.undo()
    # one single PJ run (stage 8, exact mode) in each, on the same diffs
    single = {}
    for tag, cfg in (("jax", jcfg), ("port", pcfg)):
        mp = pytest.MonkeyPatch()
        if tag == "port":
            _install_jax_draws(mp, PR["seed"], PJ_SINGLE["seed"])
        res = out[tag]["res"]
        unproj = out[tag]["ws"].compunproj("synth", res["pr_ref"])
        single[tag] = out[tag]["ws"].pjlearn(
            unproj, cfg.PJLearnConfig(**PJ_SINGLE))
        mp.undo()
        out[tag]["single"] = single[tag]
        out[tag]["unproj"] = unproj
    return out


def _read(path, name):
    with JaxStore(path, "r") as st:
        return st.read(name) if st.exists(name) else None


def _meta(path, key):
    with JaxStore(path, "r") as st:
        return st.get_meta(key)


def _base(p):
    return os.path.basename(p)


def test_pr_winner_and_unprojected_diffs_match(runs):
    rp, rj = runs["port"]["res"], runs["jax"]["res"]
    assert _base(rp["pr_ref"]) == _base(rj["pr_ref"])
    assert rp["best_pr"]["dim"] == rj["best_pr"]["dim"]
    up, uj = runs["port"]["unproj"], runs["jax"]["unproj"]
    assert _base(up) == _base(uj)
    np.testing.assert_array_equal(_read(up, "Label"), _read(uj, "Label"))
    dp, dj = _read(up, "Distance"), _read(uj, "Distance")
    assert dp.shape == dj.shape and dp.shape[0] == 192
    assert dp.shape[1] % 8 == 0 and dp.shape[1] <= 128
    np.testing.assert_allclose(dp, dj, rtol=REL, atol=1e-5)


def test_pj_sweep_models_and_stats_match(runs):
    rp, rj = runs["port"]["res"], runs["jax"]["res"]
    mp = {_base(m["model"]): m for m in rp["pj_models"]}
    mj = {_base(m["model"]): m for m in rj["pj_models"]}
    assert sorted(mp) == sorted(mj) and len(mp) == 4
    for name in mp:
        a, b = mp[name], mj[name]
        assert a["dim"] == b["dim"]
        assert a["fpr95"] == pytest.approx(b["fpr95"], abs=1e-5)
        assert a["auc"] == pytest.approx(b["auc"], abs=1e-5)
        ap, aj = _read(a["model"], "A"), _read(b["model"], "A")
        assert np.abs(ap - aj).max() <= REL * np.abs(aj).max()
        wp, wj = _read(a["model"], "W"), _read(b["model"], "W")
        assert wp.shape == wj.shape
        # W up to row signs: the metric W^T W is what both hold
        np.testing.assert_allclose(wp.T @ wp, wj.T @ wj,
                                   atol=REL * np.abs(aj).max())
    for a, b in zip(rp["pj_records"], rj["pj_records"]):
        assert _base(a["model"]) == _base(b["model"])
        assert a["dim"] == b["dim"]
        assert a["fpr95"] == pytest.approx(b["fpr95"], abs=1e-5)
        assert a["auc"] == pytest.approx(b["auc"], abs=1e-5)
    for dim in DIMS:
        order_p = [_base(r["model"]) for r in
                   Workspace.pj_rank_cross(rp["pj_records"], max_dim=dim)]
        order_j = [_base(r["model"]) for r in
                   JaxWorkspace.pj_rank_cross(rj["pj_records"], max_dim=dim)]
        assert order_p == order_j
    assert sorted(rp["exports"]) == sorted(rj["exports"]) == list(DIMS)


def test_pjlearn_matches_jax(runs):
    sp, sj = runs["port"]["single"], runs["jax"]["single"]
    assert _base(sp) == _base(sj)
    for name in ("A", "best_A"):
        ap, aj = _read(sp, name), _read(sj, name)
        assert np.abs(ap - aj).max() <= REL * np.abs(aj).max()
    assert _read(sp, "W").shape == _read(sj, "W").shape
    bp, bj = _meta(sp, "best"), _meta(sj, "best")
    assert bp["fpr95"] == pytest.approx(bj["fpr95"], abs=1e-5)
    assert bp["auc"] == pytest.approx(bj["auc"], abs=1e-5)
    assert _meta(sp, "done_iters") == _meta(sj, "done_iters") == "20"


def test_export_is_byte_identical_and_round_trips(runs, tmp_path):
    """Fed the same PR ref and the same W, the port writes the JAX
    package's header byte for byte; its own headers parse and load."""
    rj = runs["jax"]["res"]
    wj = runs["jax"]["ws"]
    for dim, path in rj["exports"].items():
        ours = export_opencv(wj.genpr(), rj["pr_ref"],
                             rj["pj_ranked"][dim]["model"],
                             str(tmp_path / f"{dim}.i"))
        with open(ours, "rb") as a, open(path, "rb") as b:
            assert a.read() == b.read()
    for dim, path in runs["port"]["res"]["exports"].items():
        with open(path) as fh:
            text = fh.read()
        mats = parse_vgg_header(text)
        desc = VGGDescriptor.from_header(text, device="cpu")
        assert mats["PJ"].shape[1] == 8 * mats["PR"].shape[0]
        assert 0 < desc.n_dim <= dim


def test_stages_are_idempotent(runs):
    ws = runs["port"]["ws"]
    res = runs["port"]["res"]
    stamp = {p: os.path.getmtime(p) for p in
             [runs["port"]["unproj"], runs["port"]["single"]]
             + [m["model"] for m in res["pj_models"]]}
    again = _run(ws, pcfg)
    assert again["pr_ref"] == res["pr_ref"]
    assert sorted(m["model"] for m in again["pj_models"]) == \
        sorted(m["model"] for m in res["pj_models"])
    assert ws.pjlearn(runs["port"]["unproj"],
                      pcfg.PJLearnConfig(**PJ_SINGLE)) == \
        runs["port"]["single"]
    for p, t in stamp.items():
        assert os.path.getmtime(p) == t, f"{p} was rewritten"


def _fresh_copy(runs, root):
    for sub in ("dataset", "distances", "pr-learn"):
        shutil.copytree(os.path.join(runs["port"]["ws"].root, sub),
                        os.path.join(root, sub))
    ws = _ws(Workspace, root, pcfg, device="cpu")
    ws.genpr()
    return ws


def test_resume_reproduces_uninterrupted_runs(runs, tmp_path):
    """pjlearn and the PJ sweep stopped after one log period and resumed
    from their snapshots write the artifacts of uninterrupted runs."""
    ws = _fresh_copy(runs, str(tmp_path / "a"))
    ws_full = _fresh_copy(runs, str(tmp_path / "b"))
    unproj = os.path.join(ws.root, "distances",
                          _base(runs["port"]["unproj"]))
    unproj_full = os.path.join(ws_full.root, "distances", _base(unproj))
    cfg = pcfg.PJLearnConfig(**PJ_SINGLE)
    with pytest.raises(RunInterrupted):
        ws.pjlearn(unproj, cfg, _stop_after_logs=1)
    path = ws.pjlearn(unproj, cfg)
    ref = ws_full.pjlearn(unproj_full, cfg)
    for name in ("W", "A"):
        np.testing.assert_array_equal(_read(path, name), _read(ref, name))

    grid, base = pcfg.PJSweepGrid(**PJ_GRID), pcfg.PJLearnConfig(**PJ)
    with pytest.raises(RunInterrupted):
        run_pj_sweep(ws, unproj, grid, base, _stop_after_logs=1)
    assert any(f.endswith("-sweep-ckpt.h5")
               for f in os.listdir(os.path.join(ws.root, "pj-learn")))
    resumed = run_pj_sweep(ws, unproj, grid, base)
    fresh = run_pj_sweep(ws_full, unproj_full, grid, base)
    assert [(r["mu"], r["gamma"], r["fpr95"]) for r in resumed] == \
        [(r["mu"], r["gamma"], r["fpr95"]) for r in fresh]
    for a, b in zip(resumed, fresh):
        np.testing.assert_array_equal(_read(a["model"], "A"),
                                      _read(b["model"], "A"))


def test_non_finite_diffs_and_objectives_fail(runs, tmp_path):
    """compunproj hard-fails a block with NaN/Inf
    (src/comp-uprjdists.cpp:341-345); pjlearn and the PJ sweep hard-fail
    a non-finite objective."""
    ws = _fresh_copy(runs, str(tmp_path))
    pr_ref = runs["port"]["res"]["pr_ref"]
    pr_ref = os.path.join(ws.root, "pr-learn", _base(pr_ref))
    with ArtifactStore(ws.genpr(), "a") as st:
        f = st.read("PRFilters")
        f[:] = np.nan
        st.write("PRFilters", f)
    with pytest.raises(FloatingPointError):
        ws.compunproj("synth", pr_ref)
    unproj = os.path.join(ws.root, "distances",
                          _base(runs["port"]["unproj"]))
    with ArtifactStore(unproj, "a") as st:
        st.write("Distance", np.full(st.shape("Distance"), 1e20, np.float32))
    with pytest.raises(FloatingPointError):
        ws.pjlearn(unproj, pcfg.PJLearnConfig(**PJ_SINGLE))
    with pytest.raises(FloatingPointError):
        run_pj_sweep(ws, unproj, pcfg.PJSweepGrid(**PJ_GRID),
                     pcfg.PJLearnConfig(**PJ))
