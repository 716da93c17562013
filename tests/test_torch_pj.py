"""The port's PJ learner and PJ statistics, held against the JAX package on
the same numpy data, the same starting state (carried across with
PJState.from_numpy) and the same sampled rows (the JAX key schedule).

What is held: A = W^T W, the projected norms ||W x||^2, the rank, df_avg
and the counters; never W itself, whose eigenvector signs differ between
LAPACK builds. Tolerance: f32 products summed in other orders, then an
eigendecomposition, over a few steps: relative 1e-4 of each quantity's
largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opencv_dlco_tpu.data.synthetic import synth_pj_dataset
from opencv_dlco_tpu.models import pj_rda as jax_pj
from opencv_dlco_tpu.models import select as jax_select

import opencv_dlco_tpu_torch.models.pj_rda as port_pj
from opencv_dlco_tpu_torch.models import select as port_select

from test_torch_rda import jax_rows

F_DIM = 40
BATCH = 48
REL = 1e-4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    pos, neg, _ = synth_pj_dataset(rng, n_pos=240, n_neg=240, n_feat=F_DIM)
    return pos.astype(np.float32), neg.astype(np.float32)


def _close(ours, ref, what):
    ours = ours.detach().cpu().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ours - ref).max())
    assert err <= REL * scale, f"{what}: max err {err} vs scale {scale}"


def _hold(st_p, st_j, x):
    """A, df_avg, ||Wx||^2 on rows x, rank and t of two states."""
    _close(st_p.a, st_j.a, "A")
    _close(st_p.df_avg, st_j.df_avg, "df_avg")
    xt = torch.from_numpy(x)
    _close(port_pj._proj_sq_norms(st_p.w, xt),
           jax_pj._proj_sq_norms(st_j.w, jnp.asarray(x))
           if st_j.w.ndim == 2 else
           jax.vmap(jax_pj._proj_sq_norms, (0, None))(st_j.w, jnp.asarray(x)),
           "||Wx||^2")
    rank_p = (st_p.w != 0).any(dim=-1).sum(dim=-1).numpy()
    rank_j = np.asarray(jnp.sum(jnp.any(st_j.w != 0.0, axis=-1), axis=-1))
    np.testing.assert_array_equal(rank_p, rank_j)
    assert st_p.t == int(np.asarray(st_j.t).reshape(-1)[0])


def _warm_state(pos, neg, mode, rank_cap=None):
    """A JAX state a few steps in (not the trivial zero state)."""
    st0 = jax_pj.pj_init(F_DIM, rank_cap)
    return jax_pj.pj_train_chunk(jnp.asarray(pos), jnp.asarray(neg), 0.001,
                                 0.5, st0, jax.random.PRNGKey(1),
                                 batch=BATCH, n_steps=3, eigh_mode=mode)


@pytest.mark.parametrize("mode,rank_cap", [("exact", None),
                                           ("subspace", None),
                                           ("subspace", 24),
                                           ("psd_ns", None)])
def test_pj_train_chunk_matches_jax(data, monkeypatch, mode, rank_cap):
    pos, neg = data
    st_j0 = _warm_state(pos, neg, mode, rank_cap)
    st_p0 = port_pj.PJState.from_numpy(
        {k: np.asarray(v) for k, v in st_j0._asdict().items()}, device="cpu")
    key = jax.random.PRNGKey(7)
    rows = jax_rows(key, 5, pos.shape[0], neg.shape[0], BATCH)
    monkeypatch.setattr(port_pj, "draw_gather_rows", lambda *a: rows)
    st_j = jax_pj.pj_train_chunk(jnp.asarray(pos), jnp.asarray(neg), 0.002,
                                 0.25, st_j0, key, batch=BATCH, n_steps=5,
                                 eigh_mode=mode)
    st_p = port_pj.pj_train_chunk(torch.from_numpy(pos),
                                  torch.from_numpy(neg), 0.002, 0.25, st_p0,
                                  torch.Generator(), batch=BATCH, n_steps=5,
                                  eigh_mode=mode)
    assert tuple(st_p.w.shape) == tuple(st_j.w.shape)
    _hold(st_p, st_j, pos[:64])


def test_pj_train_chunk_batch_matches_jax(data, monkeypatch):
    pos, neg = data
    mus = np.array([0.0005, 0.001, 0.003], np.float32)
    gammas = np.array([0.1, 0.5, 1.0], np.float32)
    st_j0 = jax_pj.pj_init_batch(F_DIM, 3)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    rows = [jax_rows(k, 4, pos.shape[0], neg.shape[0], BATCH) for k in keys]
    monkeypatch.setattr(port_pj, "draw_sweep_rows", lambda *a: (
        torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows])))
    st_j = jax_pj.pj_train_chunk_batch(
        jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(mus),
        jnp.asarray(gammas), st_j0, keys, batch=BATCH, n_steps=4,
        eigh_mode="psd_ns")
    st_p = port_pj.pj_train_chunk_batch(
        torch.from_numpy(pos), torch.from_numpy(neg), torch.from_numpy(mus),
        torch.from_numpy(gammas), port_pj.pj_init_batch(F_DIM, 3,
                                                        device="cpu"),
        torch.Generator(), batch=BATCH, n_steps=4, eigh_mode="psd_ns")
    _hold(st_p, st_j, pos[:64])
    # the stacked validation, entry by entry against the JAX one
    out_p = port_pj.pj_validate(torch.from_numpy(pos), torch.from_numpy(neg),
                                torch.from_numpy(mus), st_p)
    out_j = jax.vmap(jax_pj.pj_validate, in_axes=(None, None, 0, 0))(
        jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(mus), st_j)
    for a, b in zip(out_p[:3], out_j[:3]):
        _close(a, b, "validation")
    np.testing.assert_array_equal(out_p[3].numpy(), np.asarray(out_j[3]))


def test_pj_validate_matches_jax(data):
    pos, neg = data
    st_j = _warm_state(pos, neg, "exact")
    st_p = port_pj.PJState.from_numpy(
        {k: np.asarray(v) for k, v in st_j._asdict().items()}, device="cpu")
    out_p = port_pj.pj_validate(torch.from_numpy(pos[:100]),
                                torch.from_numpy(neg[:90]), 0.001, st_p)
    out_j = jax_pj.pj_validate(jnp.asarray(pos[:100]), jnp.asarray(neg[:90]),
                               jnp.float32(0.001), st_j)
    for a, b in zip(out_p[:3], out_j[:3]):
        assert float(a) == pytest.approx(float(b), rel=REL)
    assert int(out_p[3]) == int(out_j[3])


def test_pj_state_numpy_round_trip(data):
    pos, neg = data
    st_j = jax_pj.pj_init_batch(F_DIM, 2)
    fields = {k: np.asarray(v) for k, v in st_j._asdict().items()}
    st_p = port_pj.PJState.from_numpy(fields, device="cpu")
    back = st_p.to_numpy()
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    bad = dict(fields, t=np.array([1, 2], np.int32))
    with pytest.raises(ValueError):
        port_pj.PJState.from_numpy(bad, device="cpu")


def test_pj_train_converges_like_jax(data):
    """The host loop: the same budget improves the objective and finds a
    low rank, as the JAX pj_train does (different RNG streams, so the
    outcomes are compared as properties, not values)."""
    from opencv_dlco_tpu_torch.utils.configs import PJLearnConfig

    pos, neg = data
    cfg = PJLearnConfig(mu=0.002, gamma=0.5, n_iter=60, log_step=20,
                        batch=BATCH)
    w_best, hist = port_pj.pj_train(
        torch.from_numpy(pos[:200]), torch.from_numpy(neg[:200]),
        torch.from_numpy(pos[200:]), torch.from_numpy(neg[200:]), cfg)
    assert len(hist) == 3 and hist[-1]["obj_best"] <= hist[0]["obj"]
    assert 0 < int(np.sum(np.any(w_best != 0.0, axis=1))) <= F_DIM


def test_pj_stats_match_jax(data):
    pos, neg = data
    st_j = _warm_state(pos, neg, "exact")
    w = np.array(st_j.w)
    diffs = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))]
                            ).astype(np.int32)
    ours = port_select.compute_pj_stats(torch.from_numpy(diffs),
                                        torch.from_numpy(labels), w)
    ref = jax_select.compute_pj_stats(jnp.asarray(diffs),
                                      jnp.asarray(labels), w)
    assert ours["dim"] == ref["dim"]
    assert ours["fpr95"] == pytest.approx(ref["fpr95"], abs=1e-6)
    assert ours["auc"] == pytest.approx(ref["auc"], abs=1e-5)
    splits = {"pos_trn": pos[:200], "neg_trn": neg[:200],
              "pos_val": pos[200:], "neg_val": neg[200:]}
    ours = port_select.compute_pj_stats_splits(
        {k: torch.from_numpy(v) for k, v in splits.items()}, w)
    ref = jax_select.compute_pj_stats_splits(
        {k: jnp.asarray(v) for k, v in splits.items()}, w)
    assert ours == pytest.approx(ref, abs=1e-5)
    np.testing.assert_allclose(
        port_select.pj_model_distances(torch.from_numpy(w),
                                       torch.from_numpy(diffs)).numpy(),
        np.asarray(jax_select.pj_model_distances(jnp.asarray(w),
                                                 jnp.asarray(diffs))),
        rtol=REL)
