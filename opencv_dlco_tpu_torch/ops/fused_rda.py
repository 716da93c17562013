"""Kernels B, C and D: fused PR-RDA block steps.

Port of ``opencv_dlco_tpu/ops/fused_rda.py``. Every wrapper takes the
block offsets as an input, an (n_steps, 2) int32 table in tile_b units
drawn by ``draw_block_offsets`` (the JAX wrappers draw the same
distribution inside from a PRNG key, ``fused_rda.py:191-199``):

- ``fused_block_train_wide``: kernel B, the wide sweep axis (S > 8),
  ``csrc/rda_wide.cu``. It serves both TPU twins, ``fused_block_train_wide``
  and ``fused_block_train_wide_pipelined``. The resident w rides at the
  input dtype; the returned w is recomputed in f32 from df. With bf16
  splits a step is three launches: f in F slices (``k_slices``) with fd
  kept in a scratch, the gate summing the slices in order, then df and w
  (scratch shapes: ``wide_scratch``).
- ``fused_block_train``: kernel C, S <= 8 with f32 w, df and g,
  ``csrc/rda_narrow.cu``: one persistent launch for all steps, each
  sampled row read once a step, and the per-CTA partial subgradients
  summed in a fixed order (the kernel's header states it).
- ``fused_block_grad``: kernel D, one block's subgradient, run as the
  gradient mode of kernel C.

On a CPU tensor each wrapper runs its ``*_plain`` version, the same
function in plain PyTorch; on a CUDA tensor it launches the kernel or
raises. The wrappers are functional: they copy the solver state they are
given and return new tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def draw_block_offsets(gen: torch.Generator, n_steps: int, n_pos: int,
                       n_neg: int, batch: int, tile_b: int) -> torch.Tensor:
    """(n_steps, 2) int32 block starts in tile_b units, one uniform draw per
    side per step from [0, (n - batch) // tile_b]: a uniform sample without
    replacement over tile-aligned windows of the pre-shuffled rows.
    With tile_b = 1 these are the row starts of the unfused block mode."""
    hi_p = (n_pos - batch) // tile_b + 1
    hi_n = (n_neg - batch) // tile_b + 1
    ip = torch.randint(0, hi_p, (n_steps,), generator=gen)
    ineg = torch.randint(0, hi_n, (n_steps,), generator=gen)
    return torch.stack([ip, ineg], dim=1).to(torch.int32)


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.float32(x))


def _step_times(t: int, step: int, batch: int):
    """(t, t + B) of a step as float32, the TPU kernels' arithmetic."""
    tf = _f32(t) + _f32(step) * _f32(batch)
    return tf, tf + _f32(batch)


def _final_w(df, t_new, mu, gamma):
    tnf = _f32(t_new).to(df.device)
    return torch.clamp(-torch.sqrt(tnf) / gamma[:, None] * (df + mu[:, None]),
                       min=0.0)


def _check(pos, neg, w, offs, batch, tile_b, what):
    if batch % tile_b:
        raise ValueError(f"batch {batch} not a multiple of tile_b {tile_b}")
    if pos.dtype not in _DTYPES or neg.dtype != pos.dtype:
        raise ValueError(f"{what}: pos/neg must share dtype f32 or bf16, got "
                         f"{pos.dtype}, {neg.dtype}")
    if pos.shape[1] != neg.shape[1] or w.shape[1] != pos.shape[1]:
        raise ValueError(f"{what}: feature dims differ: pos {pos.shape}, "
                         f"neg {neg.shape}, w {w.shape}")
    offs = torch.as_tensor(offs).to(torch.int32).cpu()
    if offs.ndim != 2 or offs.shape[1] != 2:
        raise ValueError(f"{what}: offs must be (n_steps, 2), got "
                         f"{tuple(offs.shape)}")
    hi = torch.tensor([(pos.shape[0] - batch) // tile_b,
                       (neg.shape[0] - batch) // tile_b])
    if offs.numel() and (offs.min() < 0 or bool((offs > hi).any())):
        raise ValueError(f"{what}: block offsets out of range")
    return offs


def _cuda_args(what, pos, neg, *tensors):
    dev = pos.device
    for x in (neg, *tensors):
        if x.device != dev:
            raise ValueError(f"{what}: all tensors must be on {dev}")
    if not (pos.is_contiguous() and neg.is_contiguous()):
        raise ValueError(f"{what}: pos/neg must be contiguous")
    return dev


# -- kernel B: wide sweep axis ---------------------------------------------

N_SLICES = 8    # F slices of the bf16 route's phase 1 (split K)
K_TILE = 64     # features per phase-1 stage; F must be a multiple
ROW_TILE = 128  # batch rows per phase-1 CTA; bf16 batches must be multiples
S_COLS = 256    # S columns per phase-1 CTA (partial f is padded to these)
S_TILE = 128    # S rows per phase-2 CTA (violT is padded to these)


def k_slices(f_dim: int):
    """The bf16 route's split of F over phase-1 CTAs: [(f0, f1), ...], at
    most N_SLICES slices of whole K_TILE tiles, sizes within one tile. The
    gate sums the slices' partial f in this order."""
    nk = f_dim // K_TILE
    ns = min(N_SLICES, nk)
    return [(fs * nk // ns * K_TILE, (fs + 1) * nk // ns * K_TILE)
            for fs in range(ns)]


def wide_scratch(batch: int, f_dim: int, s_dim: int, device):
    """Scratch of the bf16 route, allocated once per call: violT
    (S padded to S_TILE, batch) bf16 0/1; fd (batch, F) bf16, each step's
    sampled difference, written by phase 1 and read by phase 2; part
    (n_slices, batch, S padded to S_COLS) f32, phase 1's partial f."""
    s_pad = -(-s_dim // S_TILE) * S_TILE
    s_cols = -(-s_dim // S_COLS) * S_COLS
    return (torch.empty((s_pad, batch), dtype=torch.bfloat16, device=device),
            torch.empty((batch, f_dim), dtype=torch.bfloat16, device=device),
            torch.empty((len(k_slices(f_dim)), batch, s_cols),
                        dtype=torch.float32, device=device))


def fused_block_train_wide_plain(pos, neg, w, df_avg, t, mu, gamma, offs, *,
                                 batch: int, tile_b: int = 128):
    """Plain PyTorch version of kernel B; returns (w, df_avg, t_new)."""
    dt = pos.dtype
    offs = torch.as_tensor(offs).tolist()
    w_res = w.to(dt)
    df = df_avg.to(torch.float32).clone()
    for step, (ip, ineg) in enumerate(offs):
        tf, tnf = (x.to(df.device) for x in _step_times(t, step, batch))
        df = df * (tf / tnf)
        for i in range(batch // tile_b):
            p0, n0 = (ip + i) * tile_b, (ineg + i) * tile_b
            fd = (pos[p0:p0 + tile_b]
                  - neg[n0:n0 + tile_b]).to(torch.float32)
            f = torch.matmul(fd, w_res.to(torch.float32).T)
            viol = (f > -1.0).to(torch.float32)
            df = df + torch.matmul(viol.T, fd) / tnf
        w_res = torch.clamp(-torch.sqrt(tnf) / gamma[:, None]
                            * (df + mu[:, None]), min=0.0).to(dt)
    t_new = t + batch * len(offs)
    return _final_w(df, t_new, mu, gamma), df, t_new


def fused_block_train_wide(pos, neg, w, df_avg, t, mu, gamma, offs, *,
                           batch: int, tile_b: int = 128):
    """n_steps fused RDA block steps for a wide sweep axis (kernel B).

    pos/neg (N, F) f32 or bf16 training splits (rows pre-shuffled); w,
    df_avg (S, F) f32; t samples consumed so far; mu, gamma (S,) f32;
    offs (n_steps, 2) block offsets in tile_b units. Returns (w, df_avg,
    t_new) with w recomputed in f32 from df_avg. The kernel needs
    F % 64 == 0 and tile_b % 64 == 0, and with bf16 splits batch % 128 == 0
    and 16-byte aligned pos/neg; other shapes raise.
    """
    offs = _check(pos, neg, w, offs, batch, tile_b, "fused_block_train_wide")
    if pos.device.type == "cpu":
        return fused_block_train_wide_plain(pos, neg, w, df_avg, t, mu, gamma,
                                            offs, batch=batch, tile_b=tile_b)
    s_dim, f_dim = w.shape
    if f_dim % 64 or tile_b % 64:
        raise ValueError(f"fused_block_train_wide: kernel B needs F % 64 == 0 "
                         f"and tile_b % 64 == 0 (F={f_dim}, tile_b={tile_b})")
    bf16 = pos.dtype == torch.bfloat16
    if bf16 and (batch % ROW_TILE or pos.data_ptr() % 16
                 or neg.data_ptr() % 16):
        raise ValueError(f"fused_block_train_wide: kernel B's bf16 route "
                         f"needs batch % {ROW_TILE} == 0 (batch={batch}) "
                         f"and 16-byte aligned pos/neg")
    dev = _cuda_args("fused_block_train_wide", pos, neg, w, df_avg, mu, gamma)
    w_res = w.to(pos.dtype).contiguous().clone()
    df = df_avg.to(torch.float32).contiguous().clone()
    mu_c = mu.to(torch.float32).contiguous()
    ga_c = gamma.to(torch.float32).contiguous()
    offs_d = offs.contiguous().to(dev)
    viol, fd, part = wide_scratch(batch, f_dim, s_dim, dev)
    lib = cuda_build.load("rda_wide")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rda_wide_train(
            _DTYPES[pos.dtype], pos.data_ptr(), neg.data_ptr(),
            w_res.data_ptr(), df.data_ptr(), mu_c.data_ptr(),
            ga_c.data_ptr(), offs_d.data_ptr(), viol.data_ptr(),
            fd.data_ptr(), part.data_ptr(), offs.shape[0], int(t), batch,
            tile_b, f_dim, s_dim, pos.shape[0], neg.shape[0], part.shape[0],
            stream)
    cuda_build.check(rc, "fused_block_train_wide")
    fused_block_train_wide.launches += 1
    t_new = t + batch * offs.shape[0]
    return _final_w(df, t_new, mu_c, ga_c), df, t_new


fused_block_train_wide.launches = 0


# -- kernels C and D: narrow sweep axis ---------------------------------------

def fused_block_train_plain(pos, neg, w, df_avg, t, mu, gamma, offs, *,
                            batch: int, tile_b: int = 128):
    """Plain PyTorch version of kernel C; returns (w, df_avg, t_new)."""
    offs = torch.as_tensor(offs).tolist()
    w = w.to(torch.float32).clone()
    df = df_avg.to(torch.float32).clone()
    for step, (ip, ineg) in enumerate(offs):
        tf, tnf = (x.to(df.device) for x in _step_times(t, step, batch))
        g = _block_grad_plain(pos, neg, w, ip, ineg, batch, tile_b)
        df = (tf * df + g) / tnf
        w = torch.clamp(-torch.sqrt(tnf) / gamma[:, None] * (df + mu[:, None]),
                        min=0.0)
    return w, df, t + batch * len(offs)


def _block_grad_plain(pos, neg, w, ip, ineg, batch, tile_b):
    w_q = w.to(pos.dtype).to(torch.float32)
    g = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for i in range(batch // tile_b):
        p0, n0 = (ip + i) * tile_b, (ineg + i) * tile_b
        fd = (pos[p0:p0 + tile_b] - neg[n0:n0 + tile_b]).to(torch.float32)
        viol = (torch.matmul(fd, w_q.T) > -1.0).to(torch.float32)
        g = g + torch.matmul(viol.T, fd)
    return g


def _narrow_launch(what, pos, neg, w, df, g_out, mu, gamma, offs, t, batch,
                   tile_b):
    s_dim, f_dim = w.shape
    if s_dim > 8:
        raise ValueError(f"{what}: kernel C takes S <= 8, got {s_dim}")
    lib = cuda_build.load("rda_narrow")
    if f_dim % 8 or f_dim > lib.rda_narrow_max_f(s_dim) or pos.data_ptr() \
            % 16 or neg.data_ptr() % 16:
        raise ValueError(f"{what}: kernel C needs F % 8 == 0, F <= "
                         f"{lib.rda_narrow_max_f(s_dim)} at S = {s_dim} and "
                         f"16-byte aligned pos/neg (F={f_dim})")
    dev = pos.device
    offs_d = offs.contiguous().to(dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        partial = torch.empty((lib.rda_narrow_ctas(batch), s_dim, f_dim),
                              dtype=torch.float32, device=dev)
        # the grid barrier's counter and generation word (zeroed by the run)
        barrier = torch.empty(2, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rda_narrow_run(
            _DTYPES[pos.dtype], pos.data_ptr(), neg.data_ptr(), w.data_ptr(),
            df.data_ptr(), ptr(g_out), ptr(mu), ptr(gamma), offs_d.data_ptr(),
            partial.data_ptr(), barrier.data_ptr(), offs.shape[0],
            int(t), batch, tile_b, f_dim, s_dim, stream)
    cuda_build.check(rc, what)


def fused_block_train(pos, neg, w, df_avg, t, mu, gamma, offs, *,
                      batch: int, tile_b: int = 128):
    """n_steps fused RDA block steps, S <= 8 (kernel C).

    Same arguments as fused_block_train_wide; w, df_avg and g stay f32.
    Returns (w, df_avg, t_new)."""
    offs = _check(pos, neg, w, offs, batch, tile_b, "fused_block_train")
    if pos.device.type == "cpu":
        return fused_block_train_plain(pos, neg, w, df_avg, t, mu, gamma,
                                       offs, batch=batch, tile_b=tile_b)
    _cuda_args("fused_block_train", pos, neg, w, df_avg, mu, gamma)
    w_out = w.to(torch.float32).contiguous().clone()
    df = df_avg.to(torch.float32).contiguous().clone()
    if offs.shape[0]:
        _narrow_launch("fused_block_train", pos, neg, w_out, df, None,
                       mu.to(torch.float32).contiguous(),
                       gamma.to(torch.float32).contiguous(), offs, t, batch,
                       tile_b)
        fused_block_train.launches += 1
    return w_out, df, t + batch * offs.shape[0]


fused_block_train.launches = 0


def fused_block_grad_plain(pos, neg, w, ip0_blk: int, in0_blk: int, *,
                           batch: int, tile_b: int = 128) -> torch.Tensor:
    """Plain PyTorch version of kernel D: (S, F) f32 subgradient."""
    return _block_grad_plain(pos, neg, w.to(torch.float32), int(ip0_blk),
                             int(in0_blk), batch, tile_b)


def fused_block_grad(pos, neg, w, ip0_blk: int, in0_blk: int, *,
                     batch: int, tile_b: int = 128) -> torch.Tensor:
    """Hinge-violator subgradient over one sampled block (kernel D, the
    gradient mode of kernel C): g = sum over violating samples of
    FeatDiff, (S, F) f32. Offsets are in units of tile_b rows."""
    offs = _check(pos, neg, w, [[int(ip0_blk), int(in0_blk)]], batch, tile_b,
                  "fused_block_grad")
    if pos.device.type == "cpu":
        return fused_block_grad_plain(pos, neg, w, ip0_blk, in0_blk,
                                      batch=batch, tile_b=tile_b)
    _cuda_args("fused_block_grad", pos, neg, w)
    w32 = w.to(torch.float32).contiguous()
    g = torch.empty(w32.shape, dtype=torch.float32, device=pos.device)
    _narrow_launch("fused_block_grad", pos, neg, w32, w32, g, None, None,
                   offs, 0, batch, tile_b)
    fused_block_grad.launches += 1
    return g


fused_block_grad.launches = 0
