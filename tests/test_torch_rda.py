"""The port's PR-RDA solver and the plain versions of kernels B, C and D,
held against the JAX package (its Pallas kernels in interpret mode) on the
same numpy inputs and the same sampled block offsets.

The JAX wrappers draw their offsets from a PRNG key inside; ``jax_offsets``
reproduces that draw so the port's wrappers get the identical table, and
``JaxDraws`` stands in for the port's draw functions with the JAX key
schedule so whole chunks and runs can be compared sample for sample.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opencv_dlco_tpu.models import pr_rda as jax_pr
from opencv_dlco_tpu.ops import fused_rda as jax_fused

import opencv_dlco_tpu_torch.models.pj_rda as port_pj
import opencv_dlco_tpu_torch.models.pr_rda as port_pr
from opencv_dlco_tpu_torch.ops import fused_rda as port_fused
from opencv_dlco_tpu_torch.ops.fused_rda import (
    _step_times,
    draw_block_offsets,
    fused_block_grad,
    fused_block_grad_plain,
    fused_block_train,
    fused_block_train_plain,
    fused_block_train_wide,
    fused_block_train_wide_plain,
)

# tolerances of the JAX suite (tests/test_fused_rda.py)
F32 = dict(rtol=3e-5, atol=3e-4)
BF16 = dict(rtol=5e-3, atol=0.5)


def jax_offsets(key, n_steps, n_pos, n_neg, batch, tile_b):
    """The (n_steps, 2) table the JAX fused wrappers draw from ``key``
    (ops/fused_rda.py:191-199); with tile_b = 1 also the row starts of the
    JAX block scan (models/pr_rda.py:73-82)."""
    def draw(k):
        kp, kn = jax.random.split(k)
        ip = jax.random.randint(kp, (), 0, (n_pos - batch) // tile_b + 1)
        ineg = jax.random.randint(kn, (), 0, (n_neg - batch) // tile_b + 1)
        return jnp.stack([ip, ineg]).astype(jnp.int32)

    return torch.from_numpy(
        np.array(jax.vmap(draw)(jax.random.split(key, n_steps))))


def jax_rows(key, n_steps, n_pos, n_neg, batch):
    """The (n_steps, batch) row draws per side of one chunk from ``key``:
    one key per step, split into the positive and negative draws (the
    gather scan of models/pr_rda.py and _pj_step, pj_rda.py:158-162)."""
    def draw(k):
        kp, kn = jax.random.split(k)
        return (jax.random.randint(kp, (batch,), 0, n_pos),
                jax.random.randint(kn, (batch,), 0, n_neg))

    ip, ineg = jax.vmap(draw)(jax.random.split(key, n_steps))
    return (torch.from_numpy(np.array(ip)).long(),
            torch.from_numpy(np.array(ineg)).long())


class JaxDraws:
    """Drop-in for the port's draw functions that follows the JAX key
    schedule of run_pr_sweep / prlearn / pr_train / pjlearn / pj_train: one
    key split per chunk (sweep.py:244, stages.py:626), then the per-step
    draws of that chunk; run_pj_sweep splits the chunk key once more into
    one key per combo (sweep.py:442-443)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def _sub(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def block_offsets(self, gen, n_steps, n_pos, n_neg, batch, tile_b):
        return jax_offsets(self._sub(), n_steps, n_pos, n_neg, batch, tile_b)

    def gather_rows(self, gen, n_steps, n_pos, n_neg, batch):
        return jax_rows(self._sub(), n_steps, n_pos, n_neg, batch)

    def sweep_rows(self, gen, n_sweep, n_steps, n_pos, n_neg, batch):
        rows = [jax_rows(k, n_steps, n_pos, n_neg, batch)
                for k in jax.random.split(self._sub(), n_sweep)]
        return (torch.stack([r[0] for r in rows]),
                torch.stack([r[1] for r in rows]))

    def install(self, monkeypatch):
        monkeypatch.setattr(port_pr, "draw_block_offsets", self.block_offsets)
        monkeypatch.setattr(port_pr, "draw_gather_rows", self.gather_rows)
        monkeypatch.setattr(port_pj, "draw_gather_rows", self.gather_rows)
        monkeypatch.setattr(port_pj, "draw_sweep_rows", self.sweep_rows)


def _splits(seed, n=1024, f=384, dtype=np.float32):
    rng = np.random.default_rng(seed)
    pos = np.abs(rng.normal(1.0, 0.5, (n, f))).astype(np.float32)
    neg = np.abs(rng.normal(1.2, 0.5, (n, f))).astype(np.float32)
    return pos, neg


def _grid(s):
    return (np.geomspace(0.005, 0.08, s).astype(np.float32),
            np.geomspace(0.02, 0.5, s).astype(np.float32))


def _t(x, bf16=False):
    t = torch.from_numpy(np.array(x))
    return t.to(torch.bfloat16) if bf16 else t


def _j(x, bf16=False):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if bf16 else a


# -- kernel D ------------------------------------------------------------------

@pytest.mark.parametrize("s_dim,bf16", [(1, False), (8, False), (1, True)])
def test_kernel_d_plain_matches_pallas(s_dim, bf16):
    pos, neg = _splits(11)
    rng = np.random.default_rng(3)
    w = np.abs(rng.normal(0, 0.1, (s_dim, pos.shape[1]))).astype(np.float32)
    tol = BF16 if bf16 else dict(rtol=2e-5, atol=2e-4)
    for ip, ineg in [(0, 0), (3, 1), (6, 6)]:
        ours = fused_block_grad(_t(pos, bf16), _t(neg, bf16), _t(w), ip,
                                ineg, batch=256, tile_b=128).numpy()
        ref = jax_fused.fused_block_grad(
            _j(pos, bf16), _j(neg, bf16), _j(w, bf16), jnp.int32(ip),
            jnp.int32(ineg), batch=256, tile_b=128, interpret=True)
        np.testing.assert_allclose(ours, np.asarray(ref), **tol)


# -- kernel C ------------------------------------------------------------------

@pytest.mark.parametrize("s_dim,bf16", [(1, False), (4, False), (1, True)])
def test_kernel_c_plain_matches_pallas(s_dim, bf16):
    pos, neg = _splits(16)
    mu, gamma = _grid(s_dim)
    f = pos.shape[1]
    key = jax.random.PRNGKey(9)
    w0 = np.zeros((s_dim, f), np.float32)
    w_j, df_j, t_j = jax_fused.fused_block_train(
        _j(pos, bf16), _j(neg, bf16), _j(w0), _j(w0), jnp.int32(0), _j(mu),
        _j(gamma), key, batch=256, n_steps=5, tile_b=128, interpret=True)
    offs = jax_offsets(key, 5, 1024, 1024, 256, 128)
    w, df, t = fused_block_train(_t(pos, bf16), _t(neg, bf16), _t(w0),
                                 _t(w0), 0, _t(mu), _t(gamma), offs,
                                 batch=256, tile_b=128)
    assert t == int(t_j) == 5 * 256
    tol = BF16 if bf16 else F32
    np.testing.assert_allclose(df.numpy(), np.asarray(df_j), **F32)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), **tol)


NARROW_WARPS = 16  # csrc/rda_narrow.cu's warps a CTA: its reduction chunks


def narrow_partition(batch, n_ctas):
    """Kernel C's rows of each CTA (csrc/rda_narrow.cu): CTA c owns block
    rows [c B / G, (c+1) B / G) of every step; G = min(SMs, batch)."""
    return [(c * batch // n_ctas, (c + 1) * batch // n_ctas)
            for c in range(n_ctas)]


def narrow_reduce_chunks(n_ctas):
    """Kernel C's reduction order: warp w sums the partials of CTAs
    [c0, c1) in CTA order, then lane l of warp 0 adds the 16 chunk sums
    in warp order."""
    return [(w * n_ctas // NARROW_WARPS, (w + 1) * n_ctas // NARROW_WARPS)
            for w in range(NARROW_WARPS)]


def _kernel_c_route(pos, neg, w, df_avg, t, mu, gamma, offs, *, batch,
                    tile_b, n_ctas, grad=False):
    """Kernel C's partition and summation order, emulated step by step:
    CTA c adds viol * fd of its rows (``narrow_partition``) in row order,
    warp w adds the partials of its CTAs (``narrow_reduce_chunks``) in CTA
    order, the 16 chunk sums are added in warp order, then the RDA update
    in f32 (each op rounded, as the kernel's __f*_rn). Returns (w, df), or
    g of the first step with ``grad``."""
    w = w.float().clone()
    df = df_avg.float().clone()
    for step, (ip, ineg) in enumerate(offs.tolist()):
        p0, n0 = ip * tile_b, ineg * tile_b
        fd = (pos[p0:p0 + batch] - neg[n0:n0 + batch]).float()
        viol = (fd @ w.to(pos.dtype).float().T > -1.0).float()
        partial = []
        for r0, r1 in narrow_partition(batch, n_ctas):
            acc = torch.zeros_like(w)
            for r in range(r0, r1):
                acc = acc + viol[r][:, None] * fd[r][None, :]
            partial.append(acc)
        g = torch.zeros_like(w)
        for c0, c1 in narrow_reduce_chunks(n_ctas):
            acc = torch.zeros_like(w)
            for c in range(c0, c1):
                acc = acc + partial[c]
            g = g + acc
        if grad:
            return g
        tf, tnf = _step_times(t, step, batch)
        df = (tf * df + g) / tnf
        w = torch.clamp(-torch.sqrt(tnf) / gamma[:, None] * (df + mu[:, None]),
                        min=0.0)
    return w, df


@pytest.fixture(scope="module")
def c_splits():
    return _splits(16, n=1024, f=256)


@pytest.mark.parametrize("n_steps", [1, 5])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("s_dim", [1, 3, 8])
def test_kernel_c_route_emulation_matches_plain_and_pallas(c_splits, s_dim,
                                                           bf16, n_steps):
    """Kernel C's row partition over 132 CTAs (an H100's SMs; 1-2 rows a
    CTA at batch 256) and its fixed reduction order, against the plain
    version and the JAX kernel in interpret mode (F 256, batch 256, tile_b
    128), at the tolerances of test_kernel_c_plain_matches_pallas; the
    gradient mode (kernel D) against its plain version."""
    pos, neg = c_splits
    mu, gamma = _grid(s_dim)
    key = jax.random.PRNGKey(s_dim + 10 * n_steps)
    rng = np.random.default_rng(s_dim)
    w0 = np.abs(rng.normal(0, 0.004, (s_dim, 256))).astype(np.float32)
    z = np.zeros_like(w0)
    w_j, df_j, _ = jax_fused.fused_block_train(
        _j(pos, bf16), _j(neg, bf16), _j(w0), _j(z), jnp.int32(0), _j(mu),
        _j(gamma), key, batch=256, n_steps=n_steps, tile_b=128,
        interpret=True)
    offs = jax_offsets(key, n_steps, 1024, 1024, 256, 128)
    args = (_t(pos, bf16), _t(neg, bf16), _t(w0), _t(z), 0, _t(mu),
            _t(gamma), offs)
    w, df = _kernel_c_route(*args, batch=256, tile_b=128, n_ctas=132)
    w_p, df_p, _ = fused_block_train_plain(*args, batch=256, tile_b=128)
    tol = BF16 if bf16 else F32
    for ref_w, ref_df in ((w_p.numpy(), df_p.numpy()),
                          (np.asarray(w_j), np.asarray(df_j))):
        np.testing.assert_allclose(df.numpy(), ref_df, **F32)
        np.testing.assert_allclose(w.numpy(), ref_w, **tol)
    g = _kernel_c_route(*args, batch=256, tile_b=128, n_ctas=132, grad=True)
    ip, ineg = offs[0].tolist()
    g_p = fused_block_grad_plain(_t(pos, bf16), _t(neg, bf16), _t(w0), ip,
                                 ineg, batch=256, tile_b=128)
    np.testing.assert_allclose(g.numpy(), g_p.numpy(),
                               **(BF16 if bf16 else dict(rtol=2e-5,
                                                         atol=2e-4)))


# -- kernel B ------------------------------------------------------------------

@pytest.mark.parametrize("twin", ["grid", "pipelined"])
def test_kernel_b_plain_matches_both_pallas_twins(twin):
    """One Hopper kernel serves both TPU twins: its plain version is held
    against each, f32 splits, from a nonzero starting state."""
    pos, neg = _splits(17)
    s_dim, f = 16, pos.shape[1]
    mu, gamma = _grid(s_dim)
    rng = np.random.default_rng(4)
    df0 = (-np.abs(rng.normal(0, 0.02, (s_dim, f)))).astype(np.float32)
    w0 = np.maximum(0, -np.sqrt(512) / gamma[:, None]
                    * (df0 + mu[:, None])).astype(np.float32)
    key = jax.random.PRNGKey(21)
    fn = (jax_fused.fused_block_train_wide if twin == "grid"
          else jax_fused.fused_block_train_wide_pipelined)
    w_j, df_j, t_j = fn(_j(pos), _j(neg), _j(w0), _j(df0), jnp.int32(512),
                        _j(mu), _j(gamma), key, batch=256, n_steps=5,
                        tile_b=128, interpret=True)
    offs = jax_offsets(key, 5, 1024, 1024, 256, 128)
    w, df, t = fused_block_train_wide(_t(pos), _t(neg), _t(w0), _t(df0), 512,
                                      _t(mu), _t(gamma), offs, batch=256,
                                      tile_b=128)
    assert t == int(t_j)
    np.testing.assert_allclose(df.numpy(), np.asarray(df_j), **F32)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), **F32)


def test_kernel_b_plain_matches_pallas_bf16():
    """bf16 splits with the resident w at bf16: df * t (the summed
    subgradient) within the JAX suite's bf16 subgradient tolerance."""
    pos, neg = _splits(18)
    s_dim, f = 16, pos.shape[1]
    mu, gamma = _grid(s_dim)
    w0 = np.zeros((s_dim, f), np.float32)
    key = jax.random.PRNGKey(22)
    w_j, df_j, t_j = jax_fused.fused_block_train_wide(
        _j(pos, True), _j(neg, True), _j(w0), _j(w0), jnp.int32(0), _j(mu),
        _j(gamma), key, batch=256, n_steps=4, tile_b=128, interpret=True)
    offs = jax_offsets(key, 4, 1024, 1024, 256, 128)
    w, df, t = fused_block_train_wide(_t(pos, True), _t(neg, True), _t(w0),
                                      _t(w0), 0, _t(mu), _t(gamma), offs,
                                      batch=256, tile_b=128)
    np.testing.assert_allclose(df.numpy() * t, np.asarray(df_j) * t, **BF16)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), **BF16)


@pytest.mark.parametrize("f_dim", [64, 384, 640, 5120])
def test_kernel_b_k_slices_partition_f(f_dim):
    """The bf16 route's split of F over phase-1 CTAs: whole 64-wide tiles,
    in order, covering F once, at most 8 slices, sizes within one tile."""
    sl = port_fused.k_slices(f_dim)
    assert len(sl) == min(8, f_dim // 64)
    assert sl[0][0] == 0 and sl[-1][1] == f_dim
    assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
    sizes = [f1 - f0 for f0, f1 in sl]
    assert all(x % 64 == 0 and x > 0 for x in sizes)
    assert max(sizes) - min(sizes) <= 64


def test_kernel_b_scratch_shapes():
    viol, fd, part = port_fused.wide_scratch(256, 640, 300, "cpu")
    assert viol.shape == (384, 256) and viol.dtype == torch.bfloat16
    assert fd.shape == (256, 640) and fd.dtype == torch.bfloat16
    assert part.shape == (8, 256, 512) and part.dtype == torch.float32


def _kernel_b_bf16_route(pos, neg, w, df_avg, t, mu, gamma, offs, batch,
                         tile_b):
    """Kernel B's bf16 dataflow in plain PyTorch: per step fd rounded once
    to bf16 (the scratch), partial f per F slice (k_slices), summed in slice
    order, the f > -1 gate, then df scaled by t/(t+B) and folded every
    tile_b rows in row order, and w rounded to bf16 at the step's end."""
    w_res = w.to(torch.bfloat16)
    df = df_avg.clone()
    slices = port_fused.k_slices(pos.shape[1])
    for step, (ip, ineg) in enumerate(offs.tolist()):
        tf, tnf = port_fused._step_times(t, step, batch)
        fd = (pos[ip * tile_b:ip * tile_b + batch].float()
              - neg[ineg * tile_b:ineg * tile_b + batch].float()
              ).to(torch.bfloat16).float()
        f = torch.zeros((batch, w.shape[0]))
        for f0, f1 in slices:
            f = f + fd[:, f0:f1] @ w_res[:, f0:f1].float().T
        viol = (f > -1.0).float()
        df = df * (tf / tnf)
        for r in range(0, batch, tile_b):
            df = df + (viol[r:r + tile_b].T @ fd[r:r + tile_b]) / tnf
        w_res = torch.clamp(-torch.sqrt(tnf) / gamma[:, None]
                            * (df + mu[:, None]), min=0.0).to(torch.bfloat16)
    return df


def test_kernel_b_bf16_route_emulation_matches_plain_and_jax():
    """The emulated bf16 route (F 640 in 8 uneven slices, S 20) against
    kernel B's plain version and the JAX kernel in interpret mode: df * t
    within the JAX suite's bf16 subgradient tolerance."""
    pos, neg = _splits(19, f=640)
    s_dim = 20
    mu, gamma = _grid(s_dim)
    w0 = np.zeros((s_dim, 640), np.float32)
    key = jax.random.PRNGKey(23)
    _, df_j, t_j = jax_fused.fused_block_train_wide(
        _j(pos, True), _j(neg, True), _j(w0), _j(w0), jnp.int32(0), _j(mu),
        _j(gamma), key, batch=256, n_steps=3, tile_b=128, interpret=True)
    offs = jax_offsets(key, 3, 1024, 1024, 256, 128)
    args = (_t(pos, True), _t(neg, True), _t(w0), _t(w0), 0, _t(mu),
            _t(gamma), offs)
    df = _kernel_b_bf16_route(*args, batch=256, tile_b=128)
    _, df_p, t = fused_block_train_wide_plain(*args, batch=256, tile_b=128)
    assert t == int(t_j) == 3 * 256
    np.testing.assert_allclose(df.numpy() * t, df_p.numpy() * t, **BF16)
    np.testing.assert_allclose(df.numpy() * t, np.asarray(df_j) * t, **BF16)


def test_block_offsets_distribution():
    """draw_block_offsets: one uniform draw per side per step over every
    tile-aligned window, int32, inside the split."""
    gen = torch.Generator().manual_seed(0)
    offs = draw_block_offsets(gen, 4000, 1024, 896, 256, 128)
    assert offs.dtype == torch.int32 and offs.shape == (4000, 2)
    assert set(offs[:, 0].tolist()) == set(range(7))
    assert set(offs[:, 1].tolist()) == set(range(6))


def test_wrappers_reject_bad_offsets():
    pos, neg = _splits(1, n=512, f=64)
    w = torch.zeros((1, 64))
    with pytest.raises(ValueError):
        fused_block_grad(_t(pos), _t(neg), w, 3, 0, batch=256, tile_b=128)
    with pytest.raises(ValueError):
        fused_block_train(_t(pos), _t(neg), w, w, 0, torch.ones(1),
                          torch.ones(1), [[0, 0]], batch=200, tile_b=128)


# -- the solver ----------------------------------------------------------------

@pytest.mark.parametrize("sampling,s_dim,split", [
    ("block", 3, "f32"), ("gather", 3, "f32"), ("block", 2, "bf16"),
    ("block_fused", 1, "f32"), ("block_fused", 16, "f32")])
def test_pr_train_chunk_matches_jax(monkeypatch, sampling, s_dim, split):
    """pr_train_chunk through every sampling mode and both fused kernels,
    with the JAX key schedule, from a JAX mid-run state."""
    JaxDraws(0).install(monkeypatch)
    pos, neg = _splits(19, n=512, f=256)
    bf16 = split == "bf16"
    mu, gamma = _grid(s_dim)
    batch = 128 if sampling == "block_fused" else 64
    key = jax.random.PRNGKey(0)
    _, sub = jax.random.split(key)
    st_j = jax_pr.pr_train_chunk(
        _j(pos, bf16), _j(neg, bf16), _j(mu), _j(gamma),
        jax_pr.pr_init(256, s_dim), sub, batch=batch, n_steps=4,
        sampling=sampling)
    st = port_pr.pr_train_chunk(
        _t(pos, bf16), _t(neg, bf16), _t(mu), _t(gamma),
        port_pr.pr_init(256, s_dim, device="cpu"), None, batch=batch,
        n_steps=4, sampling=sampling)
    assert st.t == int(st_j.t) == 4 * batch
    np.testing.assert_allclose(st.df_avg.numpy(), np.asarray(st_j.df_avg),
                               **F32)
    np.testing.assert_allclose(st.w.numpy(), np.asarray(st_j.w), **F32)


def test_pr_validate_matches_jax():
    rng = np.random.default_rng(20)
    pos_val = np.abs(rng.normal(1.0, 0.5, (300, 64))).astype(np.float32)
    neg_val = np.abs(rng.normal(1.3, 0.5, (400, 64))).astype(np.float32)
    w = np.abs(rng.normal(0, 0.05, (5, 64))).astype(np.float32)
    w[2] = 0.0
    mu = np.linspace(0.01, 0.05, 5).astype(np.float32)
    ref = jax_pr.pr_validate(jnp.asarray(pos_val), jnp.asarray(neg_val),
                             jnp.asarray(mu),
                             jax_pr.PRState(jnp.asarray(w), jnp.asarray(w),
                                            jnp.int32(0)))
    got = port_pr.pr_validate(_t(pos_val), _t(neg_val), _t(mu),
                              port_pr.pr_state_from_numpy(w, w, 0, "cpu"))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_pr_state_numpy_round_trip():
    """A JAX solver state carries into the port and back unchanged."""
    st_j = jax_pr.PRState(
        w=jnp.asarray(np.random.default_rng(1).random((3, 40)), jnp.float32),
        df_avg=-jnp.ones((3, 40), jnp.float32), t=jnp.int32(4096))
    st = port_pr.pr_state_from_numpy(np.asarray(st_j.w),
                                     np.asarray(st_j.df_avg),
                                     np.asarray(st_j.t), device="cpu")
    assert st.t == 4096 and st.w.dtype == torch.float32
    w, df, t = port_pr.pr_state_to_numpy(st)
    np.testing.assert_array_equal(w, np.asarray(st_j.w))
    np.testing.assert_array_equal(df, np.asarray(st_j.df_avg))
    assert t.dtype == np.int32 and int(t) == 4096


def test_pr_train_matches_jax(monkeypatch):
    """The single-run host driver: same history records, same best w."""
    from opencv_dlco_tpu.utils.configs import PRLearnConfig as JaxCfg
    from opencv_dlco_tpu_torch.utils.configs import PRLearnConfig

    JaxDraws(5).install(monkeypatch)
    pos, neg = _splits(24, n=400, f=128)
    kw = dict(mu=0.01, gamma=0.1, n_iter=600, log_step=200, batch=50,
              seed=5)
    w_j, hist_j = jax_pr.pr_train(_j(pos[:300]), _j(neg[:300]),
                                  _j(pos[300:]), _j(neg[300:]), JaxCfg(**kw))
    w, hist = port_pr.pr_train(_t(pos[:300]), _t(neg[:300]), _t(pos[300:]),
                               _t(neg[300:]), PRLearnConfig(**kw))
    assert len(hist) == len(hist_j) == 3
    for a, b in zip(hist, hist_j):
        assert (a["t"], a["nnz"], a["best"]) == (b["t"], b["nnz"], b["best"])
        assert a["obj"] == pytest.approx(b["obj"], rel=1e-5)
    np.testing.assert_allclose(w, w_j, **F32)
