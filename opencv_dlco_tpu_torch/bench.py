"""Benchmark suite of the port: the JAX package's suites on one CUDA card.

Port of ``opencv_dlco_tpu/bench.py``: the same suite functions, arguments
and result keys, with the inputs drawn on the device from a seeded
``torch.Generator`` (the numbers are timings; they are not the JAX draws).

Reference baselines (BASELINE.md, GTX 970 + OpenMP CPU):
- pr-learn: 100k RDA iterations in ~1.65 s  ->  60,606 samples/s
- pr-learn validation (2 GEMMs + 50k x 50k hinge): ~0.055 s
- pj-learn: 100 iterations (batch 200, 544-D eigh each) in ~7.7 s
- stage-3: 500k pairs x 40,960-filter pooling + 5,120-D ring distances

Where the JAX package times a Pallas kernel only on a TPU, this module
times the CUDA kernel only on a CUDA device (kernels B, C and E, and A in
``bench_stage3``); on the CPU those keys are absent, as they are off the
TPU. F and H run through ``knn_match``'s dispatcher in ``bench_matching``.

Keys renamed from the JAX package's, because they named a TPU unit:
- ``pallas_time`` -> ``kernel_time`` (``bench_hinge_kernels``);
- ``{label}_mxu_floor`` -> ``{label}_tc_floor`` (``bench_pr_sweep``: the
  tensor cores' floor).
Every other key keeps its JAX name. ``bench_slam`` takes its descriptor
as a header path (``run(header=...)``, ``cli bench --header``) where the
JAX suite reads the reference's shipped 64-D header from a fixed path.
The port has one kernel set for the wide grid (``csrc/rda_wide.cu``)
where the JAX package has two bit-identical twins, so
``fused_wide_pipelined_bf16_*`` time the same kernel as
``fused_wide_bf16_*`` a second time.

``run()`` writes every suite's details to ``bench_details_torch.json`` (the
committed ``bench_details.json`` is the JAX package's) and prints ONE JSON
headline line last. It runs on the CUDA card unless ``device="cpu"`` is
passed, and raises without a card. Run it as
``python -m opencv_dlco_tpu_torch.bench`` (suite from DLCO_BENCH_SUITE,
default "headline") or ``python -m opencv_dlco_tpu_torch.cli bench``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

BASELINE_PR_SAMPLES_PER_SEC = 100_000 / 1.65
BASELINE_PR_VALIDATE_SEC = 0.055
BASELINE_PJ_ITERS_PER_SEC = 100 / 7.7
BASELINE_STAGE3_PAIRS_PER_SEC = None  # reference total not published
# NVIDIA H100 SXM (80 GB HBM3) at its 700 W power limit: dense bf16
# tensor-core peak (MFU denominator) and HBM3 bandwidth (roofline floors)
PEAK_BF16_FLOPS = 989e12
HBM_BW = 3.35e12

DEFAULT_OUT = "bench_details_torch.json"


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"bench on {device!r}: CUDA is not available; pass device='cpu' "
            f"to time the plain PyTorch path")
    return dev


def _on_card(dev: torch.device) -> bool:
    return dev.type == "cuda"


def _gen(dev: torch.device, seed: int = 0) -> torch.Generator:
    """The inputs' draws, on the device."""
    return torch.Generator(device=dev).manual_seed(seed)


def _draws(seed: int = 0) -> torch.Generator:
    """A solver's row draws: a fresh generator a call, so every timed call
    draws the same rows, as the JAX suites pass one key to every call."""
    return torch.Generator().manual_seed(seed)


def _leaves(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _leaves(v)


def _fetch(out):
    """Wait until every CUDA device holding a tensor of ``out`` (nested
    tuples, lists, dicts and NamedTuples) has finished its queued work:
    PyTorch returns before a kernel ends. CPU tensors are done already."""
    devs = {t.device for t in _leaves(out) if t.device.type == "cuda"}
    for d in devs:
        torch.cuda.synchronize(d)


def _timeit(fn, *args, warmup=2, iters=6):
    """Steady-state seconds a call: the mean of ``iters`` calls after
    ``warmup`` calls, waiting for the device before each clock read."""
    for _ in range(warmup):
        out = fn(*args)
    _fetch(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _fetch(out)
    return (time.perf_counter() - t0) / iters


def _abs_normal(g, shape, mean, sd, dev, dtype=torch.float32):
    x = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
    return (mean + sd * x).abs_().to(dtype)


def bench_pr_rda(n_feat=5120, n_rows=100_000, batch=4096, steps=64,
                 sampling="block", device="cuda"):
    """PR-RDA throughput at the Brown problem shape (single sweep entry)."""
    from .models.pr_rda import pr_init, pr_train_chunk

    dev = _device(device)
    g = _gen(dev)
    # |N(1, .5)| matches ring-distance magnitudes
    pos = _abs_normal(g, (n_rows, n_feat), 1.0, 0.5, dev)
    neg = _abs_normal(g, (n_rows, n_feat), 1.2, 0.5, dev)
    mu = torch.tensor([0.025], device=dev)
    gamma = torch.tensor([0.1], device=dev)
    state = pr_init(n_feat, 1, device=dev)
    dt = _timeit(lambda: pr_train_chunk(pos, neg, mu, gamma, state,
                                        _draws(), batch=batch,
                                        n_steps=steps, sampling=sampling))
    samples_per_sec = batch * steps / dt
    out = dict(samples_per_sec=samples_per_sec, step_time=dt,
               batch=batch, steps=steps, n_feat=n_feat, n_rows=n_rows,
               vs_baseline=samples_per_sec / BASELINE_PR_SAMPLES_PER_SEC)
    if _on_card(dev):
        # kernel C (S = 1): each sampled row read once a step
        dt_f = _timeit(lambda: pr_train_chunk(
            pos, neg, mu, gamma, state, _draws(), batch=batch,
            n_steps=steps, sampling="block_fused"))
        sps_f = batch * steps / dt_f
        out.update(fused_samples_per_sec=sps_f, fused_step_time=dt_f,
                   fused_vs_baseline=sps_f / BASELINE_PR_SAMPLES_PER_SEC,
                   fused_speedup_over_block=sps_f / samples_per_sec)
        # bf16-resident splits: half the residency and the bytes a step
        pos16 = pos.to(torch.bfloat16)
        neg16 = neg.to(torch.bfloat16)
        dt_f16 = _timeit(lambda: pr_train_chunk(
            pos16, neg16, mu, gamma, state, _draws(), batch=batch,
            n_steps=steps, sampling="block_fused"))
        sps_f16 = batch * steps / dt_f16
        out.update(
            fused_bf16_samples_per_sec=sps_f16,
            fused_bf16_vs_baseline=sps_f16 / BASELINE_PR_SAMPLES_PER_SEC,
            fused_bf16_speedup_over_block=sps_f16 / samples_per_sec)
    return out


def bench_pr_sweep_brown(n_feat=5120, n_rows=200_000, batch=2048, steps=32,
                         n_sweep=256, device="cuda"):
    """The 256-combo sweep at Brown residency: 200k-row bf16 train splits
    per side (the split sizes of a 500k-pair dataset at train_frac=0.8),
    through the tuned block path and, on the card, kernel B."""
    from .models.pr_rda import pr_init, pr_train_chunk
    from .ops.fused_rda import draw_block_offsets, fused_block_train_wide

    dev = _device(device)
    g = _gen(dev)
    pos = _abs_normal(g, (n_rows, n_feat), 1.0, 0.5, dev, torch.bfloat16)
    neg = _abs_normal(g, (n_rows, n_feat), 1.2, 0.5, dev, torch.bfloat16)
    _fetch(neg)
    mus = torch.linspace(0.001, 0.06, n_sweep, device=dev)
    gammas = torch.linspace(0.005, 0.25, n_sweep, device=dev)
    state = pr_init(n_feat, n_sweep, device=dev)
    flops_per_call = 4.0 * batch * n_feat * n_sweep * steps
    out = dict(n_rows=n_rows, n_sweep=n_sweep, batch=batch, steps=steps,
               resident_gib=2 * n_rows * n_feat * 2 / 1024**3)

    def run_tuned():
        return pr_train_chunk(pos, neg, mus, gammas, state, _draws(),
                              batch=batch, n_steps=steps, sampling="block",
                              precision="default")

    def run_fused():
        # the kernel itself, not the dispatcher
        offs = draw_block_offsets(_draws(), steps, n_rows, n_rows, batch, 128)
        return fused_block_train_wide(
            pos, neg, state.w, state.df_avg, state.t, mus, gammas, offs,
            batch=batch, tile_b=128)

    for label, fn in (("tuned", run_tuned), ("fused_wide_bf16", run_fused)):
        if fn is run_fused and not _on_card(dev):
            continue
        dt = _timeit(fn)
        eff = batch * steps * n_sweep / dt
        out.update({
            f"{label}_samples_per_sec": eff,
            f"{label}_step_time": dt,
            f"{label}_vs_baseline": eff / BASELINE_PR_SAMPLES_PER_SEC,
            f"{label}_mfu": flops_per_call / dt / PEAK_BF16_FLOPS,
        })
    return out


def bench_pr_sweep(n_feat=5120, n_rows=50_000, batch=2048, steps=32,
                   n_sweep=256, sampling="block", device="cuda"):
    """The whole 256-combo grid as one loop; samples/s counts every sweep
    entry (the reference runs these as 256 sequential processes).

    Configs measured:
      * reference numerics: f32 splits, f32 products (TF32 off), the
        unfused block step;
      * tuned (card): bf16-resident splits + bf16-rounded products;
      * fused_wide, fused_wide_bf16 (card): the whole grid through kernel B
        (ops/fused_rda.fused_block_train_wide), f32 and bf16 splits, each
        sampled row read from device memory once a step.

    MFU: the step's useful flops are the two (B,F)x(F,S) products =
    4*B*F*S a step, over the card's bf16 peak. The fused rows carry
    ``hbm_floor`` (the sampled rows' bytes over HBM_BW) and ``tc_floor``
    (the products over the bf16 peak), so the gap to both stays measured.
    """
    from .models.pr_rda import pr_init, pr_train_chunk
    from .ops.fused_rda import draw_block_offsets, fused_block_train_wide

    dev = _device(device)
    g = _gen(dev)
    pos = _abs_normal(g, (n_rows, n_feat), 1.0, 0.5, dev)
    neg = _abs_normal(g, (n_rows, n_feat), 1.2, 0.5, dev)
    mus = torch.linspace(0.001, 0.06, n_sweep, device=dev)
    gammas = torch.linspace(0.005, 0.25, n_sweep, device=dev)
    state = pr_init(n_feat, n_sweep, device=dev)
    flops_per_call = 4.0 * batch * n_feat * n_sweep * steps

    def mfu(dt):
        return flops_per_call / dt / PEAK_BF16_FLOPS

    dt = _timeit(lambda: pr_train_chunk(pos, neg, mus, gammas, state,
                                        _draws(), batch=batch,
                                        n_steps=steps, sampling=sampling))
    eff_samples = batch * steps * n_sweep / dt
    out = dict(effective_samples_per_sec=eff_samples, step_time=dt,
               n_sweep=n_sweep, batch=batch, steps=steps, n_rows=n_rows,
               mfu=mfu(dt),
               vs_baseline=eff_samples / BASELINE_PR_SAMPLES_PER_SEC)
    if not _on_card(dev):
        return out
    pos16 = pos.to(torch.bfloat16)
    neg16 = neg.to(torch.bfloat16)
    dt_t = _timeit(lambda: pr_train_chunk(
        pos16, neg16, mus, gammas, state, _draws(), batch=batch,
        n_steps=steps, sampling=sampling, precision="default"))
    eff_t = batch * steps * n_sweep / dt_t
    out.update(
        tuned_samples_per_sec=eff_t, tuned_step_time=dt_t,
        tuned_vs_baseline=eff_t / BASELINE_PR_SAMPLES_PER_SEC,
        tuned_mfu=mfu(dt_t),
        tuned_config="bf16-resident splits + bf16-rounded products")

    def run_fused(p, n):
        offs = draw_block_offsets(_draws(), steps, n_rows, n_rows, batch, 128)
        return fused_block_train_wide(
            p, n, state.w, state.df_avg, state.t, mus, gammas, offs,
            batch=batch, tile_b=128)

    for label, (p, n) in (("fused_wide", (pos, neg)),
                          ("fused_wide_bf16", (pos16, neg16)),
                          ("fused_wide_pipelined_bf16", (pos16, neg16))):
        dt_f = _timeit(lambda p=p, n=n: run_fused(p, n))
        eff_f = batch * steps * n_sweep / dt_f
        out.update({
            f"{label}_samples_per_sec": eff_f,
            f"{label}_step_time": dt_f,
            f"{label}_vs_baseline": eff_f / BASELINE_PR_SAMPLES_PER_SEC,
            f"{label}_mfu": mfu(dt_f),
        })
        if label != "fused_wide_pipelined_bf16":
            out.update({
                f"{label}_hbm_floor": (2 * batch * n_feat * p.element_size()
                                       * steps / HBM_BW),
                f"{label}_tc_floor": flops_per_call / PEAK_BF16_FLOPS,
            })
    return out


def bench_pr_validate(n_feat=5120, n_pos=50_000, n_neg=50_000,
                      device="cuda"):
    """Validation: 2 GEMMs + all-pairs hinge (vs reference's 0.055 s)."""
    from .models.pr_rda import pr_init, pr_validate

    dev = _device(device)
    g = _gen(dev)
    pos = _abs_normal(g, (n_pos, n_feat), 0.0, 1.0, dev)
    neg = _abs_normal(g, (n_neg, n_feat), 0.0, 1.0, dev)
    state = pr_init(n_feat, 1, device=dev)._replace(
        w=_abs_normal(g, (1, n_feat), 0.0, 1.0, dev))
    mu = torch.tensor([0.025], device=dev)
    dt = _timeit(lambda: pr_validate(pos, neg, mu, state))
    return dict(validate_time=dt,
                vs_baseline=BASELINE_PR_VALIDATE_SEC / dt)


def bench_hinge_kernels(n=50_000, device="cuda"):
    """Kernel E (all-pairs, ``kernel_time``, card only) against the sorted
    reformulation (``sorted_time``) of the all-pairs hinge."""
    from .ops.hinge import hinge_sum_blockwise, hinge_sum_sorted

    dev = _device(device)
    g = _gen(dev)
    pos = torch.randn(n, generator=g, device=dev)
    neg = torch.randn(n, generator=g, device=dev)
    out = {"sorted_time": _timeit(lambda: hinge_sum_sorted(pos, neg))}
    if _on_card(dev):
        out["kernel_time"] = _timeit(lambda: hinge_sum_blockwise(pos, neg))
    return out


def bench_stage3(n_pairs=512, pool_cfg=None, device="cuda"):
    """Stage-3 distance throughput: patch transform + 40960-filter pooling +
    ring reduction, per pair (f32; kernel A's bf16 route on the card)."""
    from .ops.pair_distance import ring_distances
    from .ops.pair_distance_fused import TF, TK, ring_distances_fused
    from .ops.patch_transform import batch_patch_transform
    from .ops.pool_regions import build_filter_bank
    from .utils.configs import PoolRegionConfig

    dev = _device(device)
    cfg = pool_cfg or PoolRegionConfig()
    _, _, filters = build_filter_bank(cfg)
    f = torch.from_numpy(filters).to(dev)
    rng = np.random.default_rng(0)
    patches = torch.from_numpy(
        rng.integers(0, 255, (2 * n_pairs, 64, 64)).astype(np.uint8)).to(dev)

    def stage(flt, p):
        pt = batch_patch_transform(p)
        return ring_distances(flt, pt[:n_pairs], pt[n_pairs:])

    dt = _timeit(lambda: stage(f, patches), warmup=1, iters=3)
    pairs_per_sec = n_pairs / dt
    out = dict(pairs_per_sec=pairs_per_sec, block_time=dt,
               n_filters=int(f.shape[0]))
    if _on_card(dev) and f.shape[0] % TF == 0 and f.shape[1] % TK == 0:
        f16 = f.to(torch.bfloat16)

        def stage_fused(flt, p):
            pt = batch_patch_transform(p)
            return ring_distances_fused(flt, pt[:n_pairs], pt[n_pairs:],
                                        bf16=True)

        dt_f = _timeit(lambda: stage_fused(f16, patches), warmup=1, iters=3)
        out.update(fused_pairs_per_sec=n_pairs / dt_f,
                   fused_block_time=dt_f,
                   fused_speedup=dt / dt_f)
    return out


def bench_precision_fpr95(n_pairs=50_000, block=512, pool_cfg=None,
                          seed=0, device="cuda"):
    """bf16-vs-f32 stage-3 pooling measured on the END metric: FPR95/AUC
    over hard synthetic pairs (data/synthetic.HARD_PAIR_PARAMS), the full
    40,960-filter bank, PatchDist = w . ring_dists with a uniform w and a
    sparse trained-like w (13 spread rings, the published models' shape).
    The bf16 route is kernel A where the bank fits its tiles, else its
    plain version (bf16 operands, f32 products), chosen by the bank's
    shape and named in ``bf16_route``; on the card, kernel A's route
    raises unless it launched once a block (``kernel_a_launches``). bf16
    is recommended when |dFPR95| < 0.1 percentage points for both w (the
    gate PARITY.md documents)."""
    from .data.synthetic import HARD_PAIR_PARAMS, synth_patch_pairs
    from .ops.pair_distance import ring_distances
    from .ops.pair_distance_fused import (TF, TK, ring_distances_fused,
                                          ring_distances_plain)
    from .ops.patch_transform import batch_patch_transform
    from .ops.pool_regions import build_filter_bank
    from .ops.roc import roc_stats
    from .utils.configs import PoolRegionConfig

    dev = _device(device)
    cfg = pool_cfg or PoolRegionConfig()
    _, _, filters = build_filter_bank(cfg)
    f = torch.from_numpy(filters).to(dev)
    n_rings = filters.shape[0] // 8
    bf16_route = (ring_distances_fused if f.shape[0] % TF == 0
                  and f.shape[1] % TK == 0 else ring_distances_plain)
    launches0 = ring_distances_fused.launches

    rng = np.random.default_rng(seed)
    # chunked generation (the FFT texture synth is host-side)
    p1s, p2s, lbls = [], [], []
    left = n_pairs
    while left > 0:
        c = min(4096, left)
        a, b, lab = synth_patch_pairs(rng, n_pairs=c, **HARD_PAIR_PARAMS)
        p1s.append(a)
        p2s.append(b)
        lbls.append(lab)
        left -= c
    p1 = np.concatenate(p1s)
    p2 = np.concatenate(p2s)
    labels = torch.from_numpy(np.concatenate(lbls)).to(dev)

    w_uniform = np.ones(n_rings, np.float32)
    w_sparse = np.zeros(n_rings, np.float32)
    w_sparse[np.arange(17, n_rings, max(1, n_rings // 13))[:13]] = 1.0

    def block_dists(a, b, label):
        pt1 = batch_patch_transform(a)
        pt2 = batch_patch_transform(b)
        if label == "f32":
            return ring_distances(f, pt1, pt2)
        return bf16_route(f, pt1, pt2, bf16=True)

    out = {"n_pairs": int(n_pairs), "n_filters": int(f.shape[0]),
           "bf16_route": ("kernel_A" if bf16_route is ring_distances_fused
                          else "plain")}
    dists = {}
    for label in ("f32", "bf16"):
        rows = []
        t0 = time.perf_counter()
        for i in range(0, n_pairs, block):
            a = torch.from_numpy(p1[i:i + block]).to(dev)
            b = torch.from_numpy(p2[i:i + block]).to(dev)
            rows.append(block_dists(a, b, label).cpu().numpy())
        dt = time.perf_counter() - t0
        rd = np.concatenate(rows)                     # (N, n_rings)
        dists[label] = rd
        out[f"{label}_time"] = dt
        out[f"{label}_pairs_per_sec"] = n_pairs / dt
        for wname, w in (("uniform", w_uniform), ("sparse", w_sparse)):
            d = torch.from_numpy(rd @ w).to(dev)
            fpr95, auc = roc_stats(d, labels)
            out[f"{label}_{wname}_fpr95"] = float(fpr95) * 100.0
            out[f"{label}_{wname}_auc"] = float(auc)
    out["kernel_a_launches"] = ring_distances_fused.launches - launches0
    n_blocks = -(-n_pairs // block)
    if (_on_card(dev) and bf16_route is ring_distances_fused
            and out["kernel_a_launches"] != n_blocks):
        raise RuntimeError(f"precision suite: kernel A launched "
                           f"{out['kernel_a_launches']} times for "
                           f"{n_blocks} bf16 blocks")
    for wname in ("uniform", "sparse"):
        out[f"delta_fpr95_{wname}"] = (out[f"bf16_{wname}_fpr95"]
                                       - out[f"f32_{wname}_fpr95"])
        out[f"delta_auc_{wname}"] = (out[f"bf16_{wname}_auc"]
                                     - out[f"f32_{wname}_auc"])
    rel = np.abs(dists["bf16"] - dists["f32"]) / (np.abs(dists["f32"]) + 1e-6)
    out["median_rel_err"] = float(np.median(rel))
    out["bf16_safe"] = bool(
        abs(out["delta_fpr95_uniform"]) < 0.1
        and abs(out["delta_fpr95_sparse"]) < 0.1)
    return out


def bench_brown_scale(n_feat=5120, n_pos_trn=200_000, n_neg_trn=200_000,
                      n_pos_val=50_000, n_neg_val=50_000,
                      batch=4096, steps=24, device="cuda"):
    """Full-Brown-shape residency on one card: the 200k+200k train rows
    (8.2 GiB) and 50k+50k validation rows (2 GiB) of a 500k-pair dataset at
    train_frac=0.8, resident at once, then one training chunk (~100k
    samples), one validation (2 GEMMs + 50k x 50k hinge) and one
    full-dataset stats pass (split GEMVs + 500k-point ROC): every device
    step of Workspace.prlearn at full scale, with the full distance matrix
    never on the device (models/select.compute_pr_stats_splits)."""
    from .models.pr_rda import pr_init, pr_train_chunk, pr_validate
    from .models.select import _pr_split_distances, _split_roc
    from .utils.memory import check_device_budget, device_memory_bytes

    dev = _device(device)
    plan = {"pos_trn": n_pos_trn * n_feat * 4,
            "neg_trn": n_neg_trn * n_feat * 4,
            "pos_val": n_pos_val * n_feat * 4,
            "neg_val": n_neg_val * n_feat * 4}
    total = check_device_budget(plan, "bench_brown_scale", device=dev)

    g = _gen(dev)
    pos_trn = _abs_normal(g, (n_pos_trn, n_feat), 1.0, 0.5, dev)
    neg_trn = _abs_normal(g, (n_neg_trn, n_feat), 1.2, 0.5, dev)
    pos_val = _abs_normal(g, (n_pos_val, n_feat), 1.0, 0.5, dev)
    neg_val = _abs_normal(g, (n_neg_val, n_feat), 1.2, 0.5, dev)
    _fetch(neg_val)
    if _on_card(dev):
        torch.cuda.reset_peak_memory_stats(dev)

    mu = torch.tensor([0.025], device=dev)
    gamma = torch.tensor([0.1], device=dev)
    state = pr_init(n_feat, 1, device=dev)

    def chunk():
        return pr_train_chunk(pos_trn, neg_trn, mu, gamma, state, _draws(),
                              batch=batch, n_steps=steps, sampling="block")

    t_chunk = _timeit(chunk, warmup=1, iters=2)
    state2 = chunk()
    t_val = _timeit(lambda: pr_validate(pos_val, neg_val, mu, state2),
                    warmup=1, iters=2)

    def stats_pass():
        ds = _pr_split_distances(state2.w[0], pos_trn, neg_trn,
                                 pos_val, neg_val)
        return _split_roc(*ds)

    t_stats = _timeit(stats_pass, warmup=1, iters=2)
    peak = (int(torch.cuda.max_memory_allocated(dev)) if _on_card(dev)
            else None)
    return dict(
        resident_gib=total / 1024**3,
        hbm_gib=device_memory_bytes(dev) / 1024**3,
        peak_bytes_in_use=peak,
        chunk_time=t_chunk,
        samples_per_sec=batch * steps / t_chunk,
        validate_time=t_val,
        stats_pass_time=t_stats,
        vs_baseline=(batch * steps / t_chunk) / BASELINE_PR_SAMPLES_PER_SEC,
    )


def bench_pj_rda(n_feat=544, n_rows=50_000, batch=200, steps=20,
                 device="cuda"):
    """PJ-RDA iteration rate (eigh-dominated; vs reference's 13 it/s)."""
    from .models.pj_rda import pj_init, pj_train_chunk

    dev = _device(device)
    g = _gen(dev)
    pos = 0.3 * torch.randn((n_rows, n_feat), generator=g, device=dev)
    neg = 1.0 * torch.randn((n_rows, n_feat), generator=g, device=dev)
    out = {}
    for label, mode, cap in (("exact", "exact", None),
                             ("psd_ns", "psd_ns", None),
                             ("subspace", "subspace", None),
                             ("rank_cap192", "subspace", 192),
                             ("rank_cap128", "subspace", 128)):
        state = pj_init(n_feat, cap, device=dev)
        dt = _timeit(
            lambda m=mode, st=state: pj_train_chunk(
                pos, neg, 0.001, 0.5, st, _draws(),
                batch=batch, n_steps=steps, eigh_mode=m),
            warmup=1, iters=3)
        out[f"{label}_iters_per_sec"] = steps / dt
        out[f"{label}_vs_baseline"] = (steps / dt) / BASELINE_PJ_ITERS_PER_SEC
    # exact and psd_ns share every step component except the PSD
    # projection, so their per-iteration delta isolates the in-loop eigh
    out["eigh_ms_per_iter"] = 1e3 * (1.0 / out["exact_iters_per_sec"]
                                     - 1.0 / out["psd_ns_iters_per_sec"])
    return out


def bench_pj_soak(n_rows=50_000, n_iter=50_000, log_step=500,
                  exact_mus=(0.0001, 0.0010, 0.0030),
                  exact_gammas=(0.025, 0.200, 1.000),
                  grid_mus=None, grid_gammas=None, device="cuda"):
    """Reference-scale psd_ns soak: the full 45-combo PJ grid
    (workspace/08-pjlearn.sh) at 544-D for the reference's full
    50k-iteration budget, through the production sweep driver
    (parallel/sweep.run_pj_sweep), on difference vectors carrying a shipped
    liberty model's discriminative spectrum; ``exact`` reference semantics
    run the same budget on a 9-combo subgrid (corners + centre), and the
    per-combo rank/FPR95/AUC deltas on the shared combos are the quality
    evidence for psd_ns as the grid default. Needs the reference workspace
    (skipped without it)."""
    import shutil
    import tempfile

    from .data.store import ArtifactStore
    from .parallel.sweep import run_pj_sweep
    from .pipeline.stages import Workspace
    from .utils.configs import PJLearnConfig, PJSweepGrid

    shipped = ("/root/reference/workspace/pj-learn/"
               "liberty-liberty-0.035-0.250-pr#7-0.0010-0.500-pj.h5")
    if not os.path.exists(shipped):
        return {"skipped": "reference PJ model not mounted"}
    import h5py

    dev = _device(device)
    with h5py.File(shipped) as f:
        a_ref = f["A"][:].astype(np.float64)
    lam, v = np.linalg.eigh(a_ref)
    lam = np.maximum(lam, 0.0)
    f_dim = a_ref.shape[0]
    rng = np.random.default_rng(2215)
    n_side = n_rows // 2
    # non-separable planting: positives carry a fraction of the
    # discriminative energy and both sides get a shared per-pair hardness
    # scalar, calibrated so the shipped metric scores FPR95 ~ 6% (the
    # published PJ band is 3.7-13%, workspace/pj-result-table.txt)
    frac, sd = 0.4, 0.25
    s_pos = np.abs(rng.normal(frac, sd * frac, (n_side, 1)))
    s_neg = np.abs(rng.normal(1.0, sd, (n_side, 1)))
    spec = np.sqrt(lam)[None, :]
    pos = (0.05 * rng.normal(size=(n_side, f_dim))
           + s_pos * (rng.normal(size=(n_side, f_dim)) * spec) @ v.T)
    neg = (0.05 * rng.normal(size=(n_side, f_dim))
           + s_neg * (rng.normal(size=(n_side, f_dim)) * spec) @ v.T)
    dists = np.concatenate([pos, neg]).astype(np.float32)
    labels = np.concatenate([np.ones(n_side, np.int32),
                             np.zeros(n_side, np.int32)])

    tmp = tempfile.mkdtemp(prefix="dlco_pj_soak_")
    out = {"n_iter": n_iter, "n_feat": f_dim, "n_rows": n_rows,
           "log_step": log_step}
    try:
        ws = Workspace(root=tmp, progress=False, device=str(dev))
        unproj = ws.path("unproj", "soak-unproj.h5")
        with ArtifactStore(unproj, "w") as st:
            st.write("Label", labels)
            st.write("Distance", dists, compression=0)

        runs = {}
        grid_full = PJSweepGrid() if grid_mus is None else PJSweepGrid(
            mus=grid_mus, gammas=grid_gammas)
        grid_sub = PJSweepGrid(mus=exact_mus, gammas=exact_gammas)
        for mode, grid in (("psd_ns", grid_full), ("exact", grid_sub)):
            base = PJLearnConfig(n_iter=n_iter, log_step=log_step,
                                 eigh_mode=mode)
            t0 = time.perf_counter()
            res = run_pj_sweep(ws, unproj, grid, base,
                               run_label=f"soak-{mode}", ckpt_every=50)
            dt = time.perf_counter() - t0
            n_combo = len(grid.mus) * len(grid.gammas)
            runs[mode] = {(r["mu"], r["gamma"]): r for r in res}
            out[f"{mode}_n_combos"] = n_combo
            out[f"{mode}_wall_time"] = dt
            out[f"{mode}_iters_per_sec"] = n_combo * n_iter / dt
            out[f"{mode}_vs_baseline"] = (n_combo * n_iter / dt
                                          / BASELINE_PJ_ITERS_PER_SEC)

        combos, d_rank, d_fpr, d_auc = [], [], [], []
        for k, ex in runs["exact"].items():
            ns = runs["psd_ns"][k]
            combos.append({
                "mu": k[0], "gamma": k[1],
                "rank_exact": ex["dim"], "rank_psd_ns": ns["dim"],
                "fpr95_exact": ex["fpr95"], "fpr95_psd_ns": ns["fpr95"],
                "auc_exact": ex["auc"], "auc_psd_ns": ns["auc"],
            })
            d_rank.append(abs(ns["dim"] - ex["dim"])
                          / max(ex["dim"], 1))
            d_fpr.append(abs(ns["fpr95"] - ex["fpr95"]))
            d_auc.append(abs(ns["auc"] - ex["auc"]))
        out["combos"] = combos
        out["psd_ns_ranks_full_grid"] = [
            runs["psd_ns"][k]["dim"] for k in sorted(runs["psd_ns"])]
        out["max_rank_rel_delta"] = max(d_rank)
        out["max_fpr95_delta_pp"] = 100 * max(d_fpr)
        out["mean_fpr95_delta_pp"] = 100 * float(np.mean(d_fpr))
        out["max_auc_delta"] = max(d_auc)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def bench_pj_sweep(n_feat=544, n_rows=50_000, batch=200, steps=20,
                   mus=(1e-5, 1e-4, 1e-3, 3e-3, 1e-2),
                   gammas=(0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
                   device="cuda"):
    """The reference's full 45-combo PJ grid (workspace/08-pjlearn.sh:10-14,
    5 mu x 9 gamma) as one batched loop.

    Modes: "exact" batches the 45 per-step eigendecompositions into one
    (45, 544, 544) eigh; "psd_ns" replaces them with Newton-Schulz PSD
    projections (matrix products only) and pays one batched eigh per chunk
    boundary. Effective iters/s counts every grid entry; the baseline is
    the reference's 13 it/s x 1 sequential process.
    """
    from .models.pj_rda import pj_init_batch, pj_train_chunk_batch

    dev = _device(device)
    combos = [(m, g) for m in mus for g in gammas]
    s = len(combos)
    mu_v = torch.tensor([c[0] for c in combos], device=dev)
    ga_v = torch.tensor([c[1] for c in combos], device=dev)
    g = _gen(dev)
    pos = 0.3 * torch.randn((n_rows, n_feat), generator=g, device=dev)
    neg = 1.0 * torch.randn((n_rows, n_feat), generator=g, device=dev)
    out = {"n_sweep": s, "n_feat": n_feat, "batch": batch, "steps": steps}
    for mode in ("exact", "psd_ns"):
        states = pj_init_batch(n_feat, s, device=dev)
        dt = _timeit(
            lambda m=mode, st=states: pj_train_chunk_batch(
                pos, neg, mu_v, ga_v, st, _draws(),
                batch=batch, n_steps=steps, eigh_mode=m),
            warmup=1, iters=3)
        eff = s * steps / dt
        out[f"{mode}_iters_per_sec"] = eff
        out[f"{mode}_step_time"] = dt
        out[f"{mode}_vs_baseline"] = eff / BASELINE_PJ_ITERS_PER_SEC
    out["psd_ns_speedup"] = (out["psd_ns_iters_per_sec"]
                             / out["exact_iters_per_sec"])
    return out


def bench_matching(n_query=65_536, n_train=65_536, dims=(64, 128),
                   block=4096, device="cuda"):
    """Batched kNN descriptor matching throughput (BASELINE.json config 3;
    metric 'matched pairs/s/chip'): candidate pairs scored per second
    (n_query * n_train per call) and matched queries per second, at the
    learned-descriptor width (64) and the SIFT-baseline width (128).

    Three routes per width:
      * xla_highest: the scan path in f32 (``fused=False``,
        precision="highest"; the name is the JAX package's);
      * xla_default: the scan path with knn_match's default precision;
      * fused: knn_match's auto-dispatch, kernel F on the card (the scan
        path on the CPU), held to ratio-test match identity against the
        f32 scan path.
    """
    from .ops.knn import knn_match, mutual_nearest, ratio_test
    from .ops.knn_fused import knn2_fused

    dev = _device(device)
    out = {"n_query": n_query, "n_train": n_train, "block": block}
    rng = np.random.default_rng(0)
    for d in dims:
        q = torch.from_numpy(
            rng.normal(size=(n_query, d)).astype(np.float32)).to(dev)
        t = torch.from_numpy(
            rng.normal(size=(n_train, d)).astype(np.float32)).to(dev)
        dt_hi = _timeit(lambda: knn_match(
            q, t, k=2, block=block, precision="highest", fused=False))
        dt_def = _timeit(lambda: knn_match(q, t, k=2, block=block,
                                           fused=False))
        # the production path: the dispatcher, not the kernel symbol
        dt_fused = _timeit(lambda: knn_match(q, t, k=2, block=block))
        mt_xla = _timeit(lambda: mutual_nearest(q, t, block=block,
                                                fused=False))
        mt = _timeit(lambda: mutual_nearest(q, t, block=block))
        out[f"knn2_time_d{d}"] = dt_hi
        out[f"knn2_default_time_d{d}"] = dt_def
        out[f"knn2_fused_time_d{d}"] = dt_fused
        if d == dims[0]:
            # the HPatches mAP protocol's k, at one width
            out[f"knnk10_time_d{d}"] = _timeit(
                lambda: knn_match(q, t, k=10, block=block))
        out[f"pairs_per_sec_d{d}"] = n_query * n_train / dt_fused
        out[f"pairs_per_sec_xla_highest_d{d}"] = n_query * n_train / dt_hi
        out[f"pairs_per_sec_xla_default_d{d}"] = n_query * n_train / dt_def
        out[f"queries_per_sec_d{d}"] = n_query / dt_fused
        out[f"mutual_time_xla_d{d}"] = mt_xla
        out[f"mutual_time_d{d}"] = mt
        out[f"mfu_fused_d{d}"] = (2 * n_query * n_train * d / dt_fused
                                  / PEAK_BF16_FLOPS)
        # quality gate: ratio-test match identity against the f32 scan path
        d_hi, i_hi = knn_match(q, t, k=2, block=block, precision="highest",
                               fused=False)
        m_hi, _ = ratio_test(d_hi, i_hi, ratio=0.9)
        d_f, i_f = knn2_fused(q, t)
        m_f, _ = ratio_test(d_f, i_f, ratio=0.9)
        out[f"match_identity_d{d}"] = float(
            (m_hi == m_f).to(torch.float32).mean())
    return out


def bench_slam(n_frames=48, size=256, n_keypoints=256, header=None,
               device="cuda"):
    """SLAM throughput (BASELINE.json KITTI config; no reference analogue).

    Times the batched front end (detect+describe, chunked match->RANSAC->BA
    pair poses) and the full stack (keyframes, detected loop closures,
    windowed BA, Sim(3) pose graph) on a rendered closed-loop sequence,
    steady state (the second run). The descriptor is the VGG header at
    ``header`` (a ``.i`` file, such as the 64-D export of the ``e2e``
    command); skipped without one.
    """
    from .data.synthetic import render_blob_sequence
    from .models.vgg import VGGDescriptor
    from .pipeline.slam import (SlamConfig, ate_rmse, compute_features,
                                run_back_end, run_odometry)

    if header is None:
        return {"skipped": "no VGG header given (--header)"}
    dev = _device(device)
    with open(header) as fh:
        model = VGGDescriptor.from_header(fh.read(), device=dev)
    rng = np.random.default_rng(2215)
    frames, centers_gt, intr = render_blob_sequence(rng, n_frames, size=size)
    cfg = SlamConfig(n_keypoints=n_keypoints, kf_min_translation=2.5,
                     kf_min_rotation=0.05, loop_gap=10)

    def front_end():
        feats = compute_features(frames, model, cfg)
        odo = run_odometry(frames, intr, model, cfg, feats=feats)
        return feats, odo

    feats, odo = front_end()                      # warm-up run
    t0 = time.perf_counter()
    feats, odo = front_end()
    t_front = time.perf_counter() - t0

    refined = run_back_end(odo, feats, intr, cfg, device=dev)   # warm-up
    t0 = time.perf_counter()
    refined = run_back_end(odo, feats, intr, cfg, device=dev)
    t_back = time.perf_counter() - t0

    span = float(np.linalg.norm(centers_gt.max(0) - centers_gt.min(0)))
    return {
        "n_frames": n_frames, "size": size, "n_keypoints": n_keypoints,
        "front_end_sec": round(t_front, 3),
        "front_end_fps": round(n_frames / t_front, 2),
        "full_stack_sec": round(t_front + t_back, 3),
        "full_stack_fps": round(n_frames / (t_front + t_back), 2),
        "n_keyframes": int(refined.keyframes.shape[0]),
        "n_loop_closures": len(refined.loop_edges),
        "backbone_stride": (int(np.median(np.diff(odo.nodes)))
                            if odo.nodes is not None else 1),
        "ate_over_span_odometry": round(
            ate_rmse(odo.translations, centers_gt) / span, 4),
        "ate_over_span": round(
            ate_rmse(refined.translations, centers_gt) / span, 4),
    }


def headline(details: dict) -> dict:
    """The one-line summary: PR-grid throughput, the best fused or tuned
    route the sweep suite measured (the reference trains its grid as
    sequential single runs), else the single-run rate."""
    if "pr_sweep" in details:
        src = details["pr_sweep"]
        candidates = [
            (src.get("fused_wide_bf16_samples_per_sec"),
             src.get("fused_wide_bf16_vs_baseline")),
            (src.get("tuned_samples_per_sec"), src.get("tuned_vs_baseline")),
            (src["effective_samples_per_sec"], src["vs_baseline"]),
        ]
        best = max(c for c in candidates if c[0] is not None)
        return {
            "metric": "pr_sweep_samples_per_sec",
            "value": round(best[0], 1),
            "unit": "samples/s",
            "vs_baseline": round(best[1], 2),
        }
    src = details.get("pr_rda", {})
    return {
        "metric": "pr_rda_samples_per_sec",
        "value": round(src.get("samples_per_sec", 0.0), 1),
        "unit": "samples/s",
        "vs_baseline": round(src.get("vs_baseline", 0.0), 2),
    }


def run(suite: str = "headline", out_path: str = DEFAULT_OUT,
        device="cuda", header=None):
    """Run ``suite`` ("headline" by default, "all" for every suite but the
    soak) on ``device``; write the details to ``out_path`` and print the
    JSON headline as the last line of stdout. Returns the details. The
    SLAM suites describe with the VGG header at ``header`` (skipped
    without one)."""
    dev = _device(device)
    details = {"backend": dev.type,
               "device": (torch.cuda.get_device_name(dev) if _on_card(dev)
                          else "cpu")}
    if suite != "all" and os.path.exists(out_path):
        # subset runs refresh their suites inside the existing file
        # instead of clobbering the full record
        try:
            with open(out_path) as f:
                details = {**json.load(f), **details}
        except (OSError, ValueError):
            pass
    t0 = time.time()
    kw = dict(device=dev)
    if suite in ("all", "headline", "pr"):
        details["pr_rda"] = bench_pr_rda(**kw)
    if suite in ("all", "pr"):
        details["pr_validate"] = bench_pr_validate(**kw)
    if suite in ("all", "headline", "sweep"):
        details["pr_sweep"] = bench_pr_sweep(**kw)
    if suite in ("all", "sweep", "brown"):
        details["pr_sweep_brown"] = bench_pr_sweep_brown(**kw)
    if suite in ("all", "hinge"):
        details["hinge"] = bench_hinge_kernels(**kw)
    if suite in ("all", "stage3"):
        details["stage3"] = bench_stage3(**kw)
    if suite in ("all", "pj"):
        details["pj_rda"] = bench_pj_rda(**kw)
        details["pj_sweep"] = bench_pj_sweep(**kw)
    if suite == "pj_soak":
        # the reference-budget soak (hours of card time): explicit only
        details["pj_soak"] = bench_pj_soak(**kw)
    if suite in ("all", "brown"):
        details["brown_scale"] = bench_brown_scale(**kw)
    if suite in ("all", "precision"):
        details["precision_fpr95"] = bench_precision_fpr95(**kw)
    if suite in ("all", "slam"):
        details["slam"] = bench_slam(header=header, **kw)
    if suite in ("all", "slam_long"):
        # 4x the flagship sequence: front-end fps must hold, the back end
        # grows ~linearly
        details["slam_long"] = bench_slam(n_frames=192, header=header,
                                           **kw)
    if suite in ("all", "slam_xl"):
        # ~KITTI-07 length; exercises the self-correcting backbone stride
        details["slam_xl"] = bench_slam(n_frames=512, header=header,
                                         **kw)
    if suite in ("all", "matching"):
        details["matching"] = bench_matching(**kw)
    details["total_bench_time"] = time.time() - t0

    with open(out_path, "w") as f:
        json.dump(details, f, indent=2)
    print(json.dumps(details, indent=2), file=sys.stderr)
    print(json.dumps(headline(details)), flush=True)
    return details


if __name__ == "__main__":
    run(suite=os.environ.get("DLCO_BENCH_SUITE", "headline"))
