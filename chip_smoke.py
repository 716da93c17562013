#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``opencv_dlco_tpu_torch/csrc`` (one nvcc per source, in parallel).
2. Drives the trainer's stages 2-6 through the port's entry points at
   full Brown width: the 40,960-filter x 4,096-pixel bank (5,120 rings),
   64x64 patches, the full 16x16 PR grid (S = 256) with the reference-scale
   PR config (batch 2048, block_fused, bf16 splits, default precision),
   one single-run prlearn, prstats and pr_rank. The dataset is cut to
   8,192 synthetic Brown-shaped pairs and the PR budget to 3 log periods,
   for the time limit. Kernel launch counts are set to 0 just before and
   read just after; the run fails if kernel A, B or C did not launch.
3. Checks the output: distance matrix shape, finiteness and the
   positive/negative separation, the first 64 rows against the f32 route,
   a finite 256-entry sweep, saved w histories, a ranked best row.
4. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes and times kernel, plain version, the same products
   through torch.matmul (``library_ms``, a yardstick the port never calls),
   and the bound (bytes or operations over the card's peak rates).
5. Prints one JSON line with every kernel, then the card line, then
   ``{"ok": true, "device": {...}}`` as the last line. Any failed phase
   exits non-zero without that line.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
N_PAIRS = 8192
PR_BATCH = 2048
LOG_STEP = 100_000                 # the reference-scale log period
STEPS_PER_LOG = LOG_STEP // PR_BATCH
N_LOGS = 3
# published H100 SXM peaks (dense): bf16 tensor cores, f32 FFMA, HBM3
PEAK = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12

# tolerances of the JAX suite (tests/test_fused_rda.py, test_pallas_fused.py)
TOL_F32 = (3e-5, 3e-4)
TOL_BF16 = (5e-3, 0.5)
TOL_RING = (1e-4, 1e-5)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops, kind):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_close(name, got, ref, tol):
    rtol, atol = tol
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} values outside "
            f"rtol={rtol} atol={atol}; max abs err {float(err.max())}")
    return float(err.max())


def run_main_path(torch, root):
    """Stages 2-6 through the entry points a user calls; returns facts
    for the checks and the per-stage seconds."""
    from opencv_dlco_tpu_torch.parallel.sweep import run_pr_sweep
    from opencv_dlco_tpu_torch.pipeline.stages import Workspace
    from opencv_dlco_tpu_torch.utils.configs import (
        DescriptorConfig, PRLearnConfig, PRSweepGrid)

    ws = Workspace(root, progress=False, pair_block=256,
                   desc_cfg=DescriptorConfig(matmul_precision="default"),
                   device="cuda")
    secs = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t0, 3)
        return out

    timed("02_genpr", ws.genpr)
    dist = timed("03_compdist", ws.compdist, "synsmoke")
    # 3 log periods leave the iterates dense, so the reference's 640-D cap
    # would save almost no history row: the cap is lifted for the smoke
    max_dim = ws.pool_cfg.n_filters * 8
    base = PRLearnConfig(
        n_iter=N_LOGS * STEPS_PER_LOG * PR_BATCH, log_step=LOG_STEP,
        batch=PR_BATCH, max_dim=max_dim, sampling="block_fused",
        split_dtype="bf16", matmul_precision="default")
    sweep = timed("04_prsweep", run_pr_sweep, ws, "synsmoke", PRSweepGrid(),
                  base)
    # a (mu, gamma) outside the grid: a grid combo's artifact is complete
    # already and prlearn would skip it
    single_cfg = PRLearnConfig(
        mu=0.0125, gamma=0.1, n_iter=N_LOGS * STEPS_PER_LOG * PR_BATCH,
        log_step=LOG_STEP, batch=PR_BATCH, max_dim=max_dim,
        sampling="block_fused")
    single = timed("04_prlearn", ws.prlearn, "synsmoke", single_cfg)
    models = sorted(os.path.join(root, "pr-learn", f)
                    for f in os.listdir(os.path.join(root, "pr-learn"))
                    if f.endswith("-pr.h5"))
    recs = timed("05_prstats", ws.prstats, models, {"synsmoke": dist})
    ranked = timed("06_pr_rank", ws.pr_rank, recs)
    return ws, dict(dist=dist, sweep=sweep, single=single, models=models,
                    recs=recs, ranked=ranked), secs


def check_main_path(torch, np, ws, out):
    from opencv_dlco_tpu_torch.data.store import ArtifactStore as store
    from opencv_dlco_tpu_torch.ops.pair_distance import ring_distances
    from opencv_dlco_tpu_torch.ops.patch_transform import (
        batch_patch_transform)

    with store(out["dist"], "r") as st:
        d = st.read("Distance")
        lab = st.read("Label").reshape(-1)
    n_rings = ws.pool_cfg.n_rings
    assert d.shape == (N_PAIRS, n_rings), d.shape
    assert np.all(np.isfinite(d)) and d.min() >= 0.0
    assert d[lab == 1].mean() < d[lab == 0].mean(), "no pos/neg separation"
    # the first 64 rows against the f32 route on the same patches
    with store(ws.path("dataset", "synsmoke.h5"), "r") as st:
        idx = st.read("Indices")[:64]
        patches = st.read("Patches")
    f32 = torch.from_numpy(ws.load_filters()).cuda()
    pt1 = batch_patch_transform(torch.from_numpy(patches[idx[:, 0]]).cuda())
    pt2 = batch_patch_transform(torch.from_numpy(patches[idx[:, 2]]).cuda())
    ref = ring_distances(f32, pt1, pt2).cpu().numpy()
    rel = np.abs(d[:64] - ref) / (np.abs(ref) + 1e-3)
    assert np.median(rel) < 2e-2, f"stage-3 median rel err {np.median(rel)}"
    assert len(out["sweep"]) == 256
    assert all(np.isfinite(r["obj"]) for r in out["sweep"])
    with store(out["single"], "r") as st:
        assert st.get_meta("done_iters") == str(N_LOGS * STEPS_PER_LOG
                                                * PR_BATCH)
    assert out["recs"], "no w history row saved under max_dim"
    best = out["ranked"][0]
    assert 0.0 <= best["mean_fpr95"] <= 1.0
    return dict(stage3_median_rel_err_vs_f32=float(np.median(rel)),
                best_fpr95=best["mean_fpr95"], best_dim=best["dim"],
                best_model=os.path.basename(best["model"]),
                best_row=best["row"], n_rows_ranked=len(out["recs"]))


def kernel_checks(torch, ws, dist):
    """Each kernel against its plain version at the main path's shapes,
    with times, bounds and the torch.matmul yardstick."""
    from opencv_dlco_tpu_torch.data.store import ArtifactStore
    from opencv_dlco_tpu_torch.ops import fused_rda as fr
    from opencv_dlco_tpu_torch.ops.pair_distance_fused import (
        ring_distances_fused, ring_distances_plain)
    from opencv_dlco_tpu_torch.ops.patch_transform import (
        batch_patch_transform)
    from opencv_dlco_tpu_torch.utils.configs import PRSweepGrid

    results = {}
    dev = torch.device("cuda")

    # -- A: full bank, 64 pairs -------------------------------------------
    with ArtifactStore(ws.path("dataset", "synsmoke.h5"), "r") as st:
        idx = st.read("Indices")[:64]
        patches = st.read("Patches")
    filt = torch.from_numpy(ws.load_filters()).to(dev)
    f16 = filt.to(torch.bfloat16)
    pt1 = batch_patch_transform(torch.from_numpy(patches[idx[:, 0]]).to(dev))
    pt2 = batch_patch_transform(torch.from_numpy(patches[idx[:, 2]]).to(dev))
    del filt
    nf, npix = f16.shape
    b = pt1.shape[0]
    got = ring_distances_fused(f16, pt1, pt2, bf16=True)
    ref = ring_distances_plain(f16, pt1, pt2, bf16=True)
    torch.cuda.synchronize()
    err = check_close("A", got, ref, TOL_RING)
    cols = torch.cat([pt1, pt2]).to(torch.bfloat16).transpose(0, 1) \
        .reshape(npix, -1).contiguous()
    bnd, by = bound_ms(nf * npix * 2 + 2 * b * npix * 8 * 4
                       + b * (nf // 8) * 4,
                       2 * 2 * nf * npix * 8 * b, "bf16")
    results["A"] = dict(
        name="ring_distances_fused", route="cuda",
        source="opencv_dlco_tpu_torch/csrc/ring_dist.cu",
        replaces="opencv_dlco_tpu/ops/pair_distance_pallas.py:53",
        max_abs_err=err,
        ms=time_ms(torch, lambda: ring_distances_fused(
            f16, pt1, pt2, bf16=True), 10),
        plain_ms=time_ms(torch, lambda: ring_distances_plain(
            f16, pt1, pt2, bf16=True), 3),
        bound_ms=bnd, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.matmul(f16, cols), 10),
        shape=f"F {nf}x{npix} bf16, {b} pairs")
    del f16, cols

    # -- B, C, D on the main path's splits ----------------------------------
    data = ws._load_split(dist, 0.8, 2215)
    pos32 = torch.from_numpy(data["pos_trn"]).to(dev)
    neg32 = torch.from_numpy(data["neg_trn"]).to(dev)
    pos16, neg16 = pos32.to(torch.bfloat16), neg32.to(torch.bfloat16)
    n_pos, n_neg = pos32.shape[0], neg32.shape[0]
    f_dim = pos32.shape[1]
    grid = PRSweepGrid().combos()
    s = len(grid)
    mu = torch.tensor([c[0] for c in grid], device=dev)
    gamma = torch.tensor([c[1] for c in grid], device=dev)
    gen = torch.Generator().manual_seed(7)
    bt = PR_BATCH

    def lib_steps(pos, neg, s_dim, n_steps, dt):
        """The step's two products through torch.matmul, n_steps times."""
        fd = (pos[:bt] - neg[:bt]).to(dt)
        w = torch.zeros((s_dim, f_dim), device=dev, dtype=dt)
        viol = torch.ones((bt, s_dim), device=dev, dtype=dt)

        def run():
            for _ in range(n_steps):
                torch.matmul(fd, w.T)
                torch.matmul(viol.T, fd)
        return time_ms(torch, run, 3)

    for n_steps in (1, STEPS_PER_LOG):
        offs = fr.draw_block_offsets(gen, n_steps, n_pos, n_neg, bt, 128)
        z = torch.zeros((s, f_dim), device=dev)
        args = (pos16, neg16, z, z, 0, mu, gamma, offs)
        w_k, df_k, t_k = fr.fused_block_train_wide(*args, batch=bt)
        w_p, df_p, _ = fr.fused_block_train_wide_plain(*args, batch=bt)
        torch.cuda.synchronize()
        # bf16: df * t is the summed subgradient, the quantity the JAX
        # suite's bf16 tolerance is stated for
        err = check_close(f"B[{n_steps} steps]", df_k * t_k, df_p * t_k,
                          TOL_BF16)
        bnd, by = bound_ms(2 * bt * f_dim * 2 * n_steps + 4 * s * f_dim * 4,
                           4 * bt * f_dim * s * n_steps, "bf16")
        results[f"B{n_steps}"] = dict(
            name="fused_block_train_wide", route="cuda",
            source="opencv_dlco_tpu_torch/csrc/rda_wide.cu",
            replaces="opencv_dlco_tpu/ops/fused_rda.py:264",
            max_abs_err=err,
            ms=time_ms(torch, lambda: fr.fused_block_train_wide(
                *args, batch=bt), 5),
            plain_ms=time_ms(torch, lambda: fr.fused_block_train_wide_plain(
                *args, batch=bt), 2),
            bound_ms=bnd, bound_by=by,
            library_ms=lib_steps(pos16, neg16, s, n_steps, torch.bfloat16),
            shape=f"S {s}, F {f_dim}, batch {bt}, bf16, {n_steps} steps")

    for s_dim in (1, 8):
        offs = fr.draw_block_offsets(gen, STEPS_PER_LOG, n_pos, n_neg, bt, 128)
        z = torch.zeros((s_dim, f_dim), device=dev)
        args = (pos32, neg32, z, z, 0, mu[:s_dim], gamma[:s_dim], offs)
        w_k, df_k, t_k = fr.fused_block_train(*args, batch=bt)
        _, df_p, _ = fr.fused_block_train_plain(*args, batch=bt)
        torch.cuda.synchronize()
        # f32: the state itself, at the JAX suite's f32 tolerance
        err = check_close(f"C[S={s_dim}]", df_k, df_p, TOL_F32)
        bnd, by = bound_ms(
            2 * bt * f_dim * 4 * STEPS_PER_LOG + 4 * s_dim * f_dim * 4,
            4 * bt * f_dim * s_dim * STEPS_PER_LOG, "f32")
        results[f"C{s_dim}"] = dict(
            name="fused_block_train", route="cuda",
            source="opencv_dlco_tpu_torch/csrc/rda_narrow.cu",
            replaces="opencv_dlco_tpu/ops/fused_rda.py:123",
            max_abs_err=err,
            ms=time_ms(torch, lambda: fr.fused_block_train(*args, batch=bt),
                       5),
            plain_ms=time_ms(torch, lambda: fr.fused_block_train_plain(
                *args, batch=bt), 2),
            bound_ms=bnd, bound_by=by,
            library_ms=lib_steps(pos32, neg32, s_dim, STEPS_PER_LOG,
                                 torch.float32),
            shape=f"S {s_dim}, F {f_dim}, batch {bt}, f32, "
                  f"{STEPS_PER_LOG} steps")

    w_d = torch.rand((8, f_dim), generator=gen).to(dev) * 1e-3
    hi = (n_pos - bt) // 128
    g_k = fr.fused_block_grad(pos32, neg32, w_d, hi, 0, batch=bt)
    g_p = fr.fused_block_grad_plain(pos32, neg32, w_d, hi, 0, batch=bt)
    torch.cuda.synchronize()
    err = check_close("D", g_k, g_p, TOL_F32)
    bnd, by = bound_ms(2 * bt * f_dim * 4 + 2 * 8 * f_dim * 4,
                       4 * bt * f_dim * 8, "f32")
    results["D"] = dict(
        name="fused_block_grad", route="cuda",
        source="opencv_dlco_tpu_torch/csrc/rda_narrow.cu",
        replaces="opencv_dlco_tpu/ops/fused_rda.py:48",
        max_abs_err=err,
        ms=time_ms(torch, lambda: fr.fused_block_grad(
            pos32, neg32, w_d, hi, 0, batch=bt), 10),
        plain_ms=time_ms(torch, lambda: fr.fused_block_grad_plain(
            pos32, neg32, w_d, hi, 0, batch=bt), 5),
        bound_ms=bnd, bound_by=by,
        library_ms=lib_steps(pos32, neg32, 8, 1, torch.float32),
        shape=f"S 8, F {f_dim}, batch {bt}, f32, 1 block")
    return results


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as err:
        print(f"chip_smoke: {err}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "opencv_dlco_tpu_torch")):
        print("chip_smoke: run from a checkout of the repo (the "
              "opencv_dlco_tpu_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        t_start = time.perf_counter()
        card = card_line()
        print(f"card: {card}", flush=True)
        print("torch", torch.__version__, "cuda", torch.version.cuda,
              flush=True)

        from opencv_dlco_tpu_torch.data.store import BACKEND
        from opencv_dlco_tpu_torch.ops import cuda_build, fused_rda
        from opencv_dlco_tpu_torch.ops.pair_distance_fused import (
            ring_distances_fused)
        from opencv_dlco_tpu_torch.pipeline.e2e import (
            generate_synthetic_dataset)
        from opencv_dlco_tpu_torch.pipeline.stages import Workspace

        t0 = time.perf_counter()
        cuda_build.build_all()
        print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
        for name, log in cuda_build.BUILD_LOGS.items():
            for line in log.splitlines():
                if "Used" in line or "spill" in line:
                    print(f"  ptxas[{name}]: {line.strip()}")

        root = os.path.join(HERE, "workspace_torch_smoke")
        shutil.rmtree(root, ignore_errors=True)
        ws0 = Workspace(root, progress=False, device="cuda")
        t0 = time.perf_counter()
        generate_synthetic_dataset(ws0, "synsmoke", seed=11,
                                   n_pairs=N_PAIRS)
        print(f"dataset: {N_PAIRS} synthetic pairs (the full 500,000 cut "
              f"for the time limit), store backend {BACKEND}, "
              f"{time.perf_counter() - t0:.1f}s", flush=True)

        wrappers = {"A": ring_distances_fused,
                    "B": fused_rda.fused_block_train_wide,
                    "C": fused_rda.fused_block_train,
                    "D": fused_rda.fused_block_grad}
        # the stages' own log lines (one per step, stat and model row) go
        # to a file; this script prints the summary
        log_dir = os.path.join(HERE, "chiprun_out")
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "chip_smoke_stages.log"), "w") as fh:
            for fn in wrappers.values():
                fn.launches = 0
            with contextlib.redirect_stdout(fh):
                ws, out, secs = run_main_path(torch, root)
            launches = {k: fn.launches for k, fn in wrappers.items()}
        print("stage seconds:", json.dumps(secs), flush=True)
        print("main-path launches:", json.dumps(launches), flush=True)
        missing = [k for k in "ABC" if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels {missing} never launched on the "
                                 f"main path")
        facts = check_main_path(torch, np, ws, out)
        print("main path:", json.dumps(facts), flush=True)

        res = kernel_checks(torch, ws, out["dist"])
        for key, r in res.items():
            print(f"kernel {key}: " + json.dumps(r), flush=True)
        table = []
        for key, row in (("A", "A"), ("B", f"B{STEPS_PER_LOG}"), ("C", "C1"),
                         ("D", "D")):
            r = dict(res[row])
            r.pop("shape")
            table.append({**r, "launches": launches[key]})
        print(f"total: {time.perf_counter() - t_start:.1f}s", flush=True)
        shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({"kernels": table}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
