#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``opencv_dlco_tpu_torch/csrc`` (one nvcc per source, in parallel), and
   prints each kernel's registers, shared memory and spills from
   ``nvcc -Xptxas -v`` (and any ptxas performance note).
2. Draws stage 1's dataset on the card (``generate_synthetic_dataset`` on
   a CUDA workspace: two 4,096-pair chunks through
   ``synth_patch_pairs_device``), printing its seconds and pairs/s, and
   holds the generator against the numpy route: one 1,024-pair draw at
   HARD_PAIR_PARAMS by tests/test_data.py:109-140's gates, two draws from
   one seed bit-identical, and the dataset's first chunk drawn again from
   its seed bit-identical to the stored rows.
   Then drives the trainer's stages 2-6 through the port's entry points at
   full Brown width: the 40,960-filter x 4,096-pixel bank (5,120 rings),
   64x64 patches, the full 16x16 PR grid (S = 256) with the reference-scale
   PR config (batch 2048, block_fused, bf16 splits, default precision),
   one single-run prlearn, prstats and pr_rank. The dataset is cut to
   8,192 synthetic Brown-shaped pairs and the PR budget to 3 log periods,
   for the time limit. Kernel launch counts are set to 0 just before and
   read just after; the run fails if kernel A, B or C did not launch.
3. Drives stages 7-11 and the exported descriptor's evaluation: the best
   ranked PR row at the published width, 512 < dim <= 640 (the reference
   cap; more PR log periods until one exists), compunproj on the 8,192 pairs, the full 5x9 PJ grid
   (batch 200, log_step 500, psd_ns, 24 Newton-Schulz iterations) for 2
   log periods, one exact-mode pjlearn for 1, pjstats, pj_rank_cross and
   the 48/64/80/120-D exports, each round-tripped through
   ``parse_vgg_header`` and ``VGGDescriptor.from_header``; then the 64-D
   descriptor on all 16,384 patches: verification, matching mAP (k = 10),
   the 2-NN ratio test and mutual nearest neighbours. Counts are set to 0
   just before and read just after; the run fails if F or H did not launch.
3a. BASELINE config 3: the evaluation on the 16,384 patches once with the
   64-D cap's descriptor and once with the SIFT baseline
   (``ops/sift.sift_describe`` on the card): verification FPR95/AUC,
   matching mAP at k = 10 (kernel H) and the 2-NN ratio test (F), both
   rows on one line. Counts are set to 0 just before and read just after;
   the run fails unless F and H launched. sift_describe on the card is
   held against the CPU (2,048 patches, abs 1e-5), and H's and F's calls
   on the SIFT descriptors against the plain version.
3b. BASELINE config 4: tests/test_sfm.py's two-view scene (seed 2215, 220
   blobs, f 300, c 160, 320 px) written as 8-bit BMPs, and the ``sfm``
   command in-process with the 64-D cap's header, ``--intrinsics
   300,300,160,160 --keypoints 512`` (the command's defaults otherwise),
   cold and warm. Counts are set to 0 just before and read just after;
   it fails unless F launched, the pose is finite and n_inliers >= 8. F's
   call on SfM's recorded inputs (invalid rows at +-1e6) is held against
   the plain version. It fails unless tests/test_sfm.py's pose gates hold
   (n_matches >= 50, n_inliers >= 40, rms < 5e-3, rotation < 2 degrees,
   |cos t| > 0.9).
4. Drives SLAM at the repo's SLAM bench row: render_blob_sequence (seed
   2215, 48 frames, 256 px), SlamConfig(n_keypoints=256,
   kf_min_translation=2.5, kf_min_rotation=0.05, loop_gap=10) and the
   64-D header stage 11 just exported, through compute_features ->
   run_odometry -> run_back_end (bench_slam's calls), once counted (after
   a timed first forward-mode Jacobian, PyTorch's one-time set-up) and,
   after phase 7, once more for steady-state seconds and once under
   torch.profiler for the device's busy time and kernel launches, with
   each run's ATE/span and a hash of each of its G outputs. Counts are set
   to 0 just before and read just after the counted run; the run fails if
   kernel G did not launch there, if any pose is non-finite, if the
   refined poses or the refined ATE/span differ in any bit between the
   counted, steady and profiled runs (the back end's sums have a fixed
   order), or if a repeat of any pose chunk's G call on its own recorded
   inputs (masked rows included) disagrees with G's plain version.
4a. Drives the SLAM study's (192, 2215) cell
   (``tools/slam_study.run_cell``, which ``study_row`` runs) with the
   same header, its frames rendered on the host in a thread started after
   the build: 192 frames, where the backbone's node floor is 32
   (``min_backbone_nodes``) and the stride is capped at 192 // 32.
   Counts are set to 0 just before and read just after; it fails unless
   G launched there and both trajectories are finite of shape (192, 3).
   It prints the study row, the stride, the node count and the seconds,
   and holds G on every pose chunk of that run against the plain
   version (hold_g's tolerance). Its launches join the kernels line.
5. Drives the port's bench through its entry point,
   ``bench.run(suite="hinge")`` (kernel E against the sorted form at
   P = N = 50,000, 8 calls of each), writing its details file into the
   smoke's workspace; it prints the bench's JSON headline. Counts are set
   to 0 just before and read just after; the run fails unless kernel E
   launched there and the details hold ``kernel_time`` and ``sorted_time``.
5a. Multi-device, after phase 7 and before the workspace is removed:
   (a) NCCL at world size 1 in this process, started by the port's
   distributed_init: make_mesh(1, 1) on the card,
   a psum and an all_gather, the port's dry run (parallel/dryrun.py), and
   the group destroyed after; (b) two ranks on the one card over gloo (NCCL
   refuses two ranks on one GPU), this script started twice with
   ``--multi-rank RANK WORK``: each runs the dry run at JAX's (1, 2) mesh,
   ``compdist(sharded=True)`` of the 8,192 pairs at the full bank into the
   multi-writer store, the S-256 PR sweep chunk (batch 2,048, bf16,
   block_fused, 48 steps) over dp 2 and ``run_slam`` over a (2, 1) mesh at
   the SLAM bench row, each with its counts set to 0 just before and read
   just after, while this process computes one single-device sweep chunk
   with the same offsets and a single-device ``run_slam``. It fails unless
   A, B and G launched in every rank, the sharded matrix equals phase 2's
   bit for bit, the sweep chunk equals the single-device call (bit for
   bit, or within TOL_BF16, reported) and the refined poses lie within
   2e-3 of the single-device run's; each rank's seconds, launches,
   collectives and pose hash are printed and written to
   ``chiprun_out/chip_smoke_multi_device.json``. Their A, B and G launches
   join the kernels line.
5b. After phase 5, drives the ``e2e`` command
   (``pipeline/e2e.run_reference_scale``) in-process on the card at a
   reduced shape: the three datasets
   synlib/synnot/synyos drawn on the card at 8,192 pairs each (two full
   stage-1 chunks), stages 2-11 at full Brown width with the full 16 x 16
   PR grid for 6 log periods of 48 steps (``--pr-iters 600000``; after 3
   no iterate is within the 640-D cap yet) and the full 5 x 9 PJ grid for
   one log period (``--pj-iters 500``), the four exports round-tripped,
   its JSON written into the smoke's workspace. Counts are set to 0 just
   before and read just after; it fails unless B launched there, the
   summary's keys equal those of the committed ``E2E_FULL_torch.json`` at
   every level and all four exports are ok. Its stage 3 runs at the
   default DescriptorConfig's precision "highest", as the JAX package's
   run_reference_scale does: kernel A's f32 mode, and the run fails unless
   A launched in that mode once a stage-3 block (3, one 8,192-pair block a
   dataset) and in no other.
   Then the same run once more, in a fresh workspace, on the bf16 route
   through tools/e2e_memory_run.py's ``--matmul-precision default`` (its
   Workspace swap): counts set to 0 just before and read just after, it
   fails unless A launched once a stage-3 block in its bf16 mode and no
   other route ran, the same checks hold, and its
   best PR row's and each PJ winner's mean FPR95 lie within 0.5 and 1.0
   pp of the f32 run's (tests/test_torch_e2e_artifact.py's tolerances).
   Both runs' stage seconds are printed; their launches join the kernels
   line.
6. Checks the outputs: distance matrix shape, finiteness and separation,
   all 8,192 bf16 rows against the f32 route on the same pairs (the
   precision suite's median relative error, under 5e-3), a finite sweep, saved
   histories, a ranked row; finite diffs and PJ models, four exports that
   parse, finite descriptors, fused matching against the scan path, and
   each kNN kernel call of the evaluation against the plain version.
7. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (A at the 256- and 8,192-pair blocks of compdist
   and run_reference_scale and at a small block of 64 pairs, A's f32 mode
   at 256 and 8,192 pairs by the worst row's relative L2 error, with the
   f32 route it replaced and one cuBLAS product of the same operands in
   the folded layout as yardsticks and the device time of its launches at
   8,192 pairs, B at 1 and
   48 steps of the PR grid with each of its three kernels' device time a
   step from torch.profiler, C at S 1 and 8 and D with their device time
   a step and launches a call, E at the bench's P = N = 50,000 and at
   8,192 (totals against the plain version and the sorted form, partials
   against the plain version, two calls bit for bit, device time and
   launches a call from torch.profiler, the SM clock under load), F, H at
   the benchmark's shapes, F also on two-view SfM's descriptors and H on
   the SIFT baseline's (d 128), F
   on the evaluation's own descriptors in both modes (f32 through
   knn_match(precision="highest")), F and H also at the 120-D export's
   width and at widths past one D chunk, F and H in f32 at d 64 and d 576,
   G on the SLAM pose chunks' recorded inputs, also against the f32 mode
   of F's route on the same batches) and times
   kernel, plain version, one library call computing the same products or
   function where there is one (``library_ms``, a yardstick the port never
   calls), and the bound (bytes or operations over the card's peaks);
   then A's and B's device time inside 03_compdist and 04_prsweep
   (main-path launches x the per-call time) beside the stage seconds; F's
   and H's (d 64, bf16 and f32; d 576, f32), the f32 evaluation call's
   and G's (the SLAM chunk) device time and kernel launches per call, and
   their library calls', come from torch.profiler.
8. Prints one JSON line with every kernel, then the card line, then
   ``{"ok": true, "device": {...}}`` as the last line. Any failed phase
   exits non-zero without that line.
"""

import concurrent.futures
import contextlib
import hashlib
import json
import os
import re
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
PR_MAX_DIM = 640                   # the reference cap (run_reference_scale)
PR_MIN_DIM = 512                   # published PR widths lie above this
PJ_BATCH = 200
PJ_LOG_STEP = 500
PJ_SWEEP_LOGS = 2
EXPORT_DIMS = (48, 64, 80, 120)
# published H100 SXM peaks (dense): bf16 and tf32 tensor cores, f32 FFMA,
# HBM3
PEAK = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# CUDA-core instructions that are not FMAs: the FP32 pipe issues one per
# lane per clock (half the FFMA FLOP peak); compare/min/max run at half
# that (64 per SM per clock in the CUDA guide's throughput table)
F32_INSTR_PER_S = PEAK["f32"] / 2
MINMAX_INSTR_PER_S = F32_INSTR_PER_S / 2

# tolerances of the JAX suite (tests/test_fused_rda.py, test_pallas_fused.py)
TOL_F32 = (3e-5, 3e-4)
TOL_BF16 = (5e-3, 0.5)
TOL_RING = (1e-4, 1e-5)
# kernel A's timed pair blocks: a small block, Workspace.pair_block (this
# script's compdist), run_reference_scale's pair_block
A_PAIRS = (64, 256, 8192)
# ... of its f32 mode, and the limit on its worst row's relative L2 error
# against the plain version in f32 (TF32 off): a 3xTF32 product leaves
# ~1e-6, bf16 operands ~1e-3
A_F32_PAIRS = (256, 8192)
A_F32_ROW_ERR = 1e-5
# stage 3's bf16 rows against the f32 route's on the same pairs: the
# median of |bf16 - f32| / (|f32| + 1e-6), as bench_precision_fpr95
# reports it, under tests/test_precision.py's median bound
STAGE3_BF16_MEDIAN_REL_ERR = 5e-3
# the bf16 e2e run against the f32 one: tests/test_torch_e2e_artifact.py's
# tolerances on the best PR row's and each PJ winner's mean FPR95
BEST_PR_FPR95_TOL = 0.005
PJ_FPR95_TOL = 0.010


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def write_bmp_gray(path, img):
    """Write a (H, W) uint8 image as an uncompressed 8-bit BMP with a gray
    palette (bottom-up rows padded to 4 bytes): needs only numpy."""
    import numpy as np

    img = np.asarray(img, np.uint8)
    h, w = img.shape
    stride = (w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = img[::-1]
    palette = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
    palette[:, 3] = 0
    offset = 14 + 40 + palette.nbytes
    header = (b"BM" + np.array([offset + rows.nbytes, 0, offset],
                               "<u4").tobytes()
              + np.array([40, w, h], "<i4").tobytes()
              + np.array([1, 8], "<u2").tobytes()
              + np.array([0, rows.nbytes, 2835, 2835, 256, 0],
                         "<u4").tobytes())
    with open(path, "wb") as fh:
        fh.write(header + palette.tobytes() + rows.tobytes())


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


def bound_ms(n_bytes, n_ops, kind, f32_instr=0):
    """The larger of the bytes over HBM's rate and the operations over
    their unit's peak; ``f32_instr`` are CUDA-core instructions other than
    FMAs done beside the ``n_ops`` (a kernel's epilogue), bounded on their
    own at F32_INSTR_PER_S."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n_ops / PEAK[kind], f32_instr / F32_INSTR_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timer(torch, secs):
    """timed(name, fn, ...): run fn, synchronise, add its seconds."""
    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t0, 3)
        return out
    return timed


def check_close(name, got, ref, tol):
    rtol, atol = tol
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} values outside "
            f"rtol={rtol} atol={atol}; max abs err {float(err.max())}")
    return float(err.max())


def _kernel_name(mangled):
    """The plain name of a kernel from its mangled symbol: the last name of
    a nested one (_ZN <len><name>... E, e.g. inside the anonymous
    namespace), or the name of one at file scope (_Z<len><name>), with its
    integer and bool template arguments (I Li10E Lb0E E -> <10, 0>),
    after a leading float or bf16 type argument."""
    m = re.match(r"_ZN", mangled)
    pos, name = (3, mangled) if m else (2, mangled)
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:]).group(0)
        name = mangled[pos + len(n):pos + len(n) + int(n)]
        pos += len(n) + int(n)
        if not m:
            break
    targs = re.match(r"I(f|13__nv_bfloat16)?((?:L[ib]\d+E)+)E",
                     mangled[pos:])
    if targs:
        kind = {"f": ["float"], "13__nv_bfloat16": ["bf16"]}.get(
            targs.group(1), [])
        name += "<" + ", ".join(kind + re.findall(r"L[ib](\d+)E",
                                                  targs.group(2))) + ">"
    return name


def ptxas_summary(cuda_build):
    """One line per kernel of this run's builds from nvcc -Xptxas -v:
    registers, static shared memory, spill stores/loads, and the dynamic
    shared memory the wgmma kernels request at launch."""
    lines = []
    for lib, log in cuda_build.BUILD_LOGS.items():
        name, facts = None, {}
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name, facts = _kernel_name(m.group(1)), {}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                facts["spill_stores"], facts["spill_loads"] = map(
                    int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                smem = re.search(r"(\d+) bytes smem", line)
                facts.update(registers=int(m.group(1)),
                             static_smem=int(smem.group(1)) if smem else 0)
                lines.append(f"  ptxas[{lib}] {name}: " + json.dumps(facts))
            if "Performance Loss" in line:
                lines.append(f"  ptxas[{lib}] note: {line.strip()}")
    libs = {"ring_dist": [("ring_dist_wgmma", (0,)),
                          ("ring_dist_wgmma f32", (1,))],
            "rda_wide": [("wide_f_wgmma", (1,)), ("wide_df_wgmma", (2,))],
            # kernel C at the single-run width, f32 and bf16 rows
            "rda_narrow": [("narrow_persistent (F 5120, f32)", (5120, 4)),
                           ("narrow_persistent (F 5120, bf16)", (5120, 2))],
            # kernel H at d 64, d 608 (the widest row the smoke checks) and
            # d 1408 (queries streamed), F's pair selection at d 64; the
            # f32 mode at d 64 and d 576 (queries streamed); kernel G at
            # any width
            "knn_topk": [("knnk_wgmma (d 64)", (64, 0)),
                         ("knnk_wgmma pair selection (d 64)", (64, 1)),
                         ("knnk_wgmma (d 608)", (608, 0)),
                         ("knnk_wgmma (d 1408)", (1408, 0)),
                         ("knnk_wgmma f32 (d 64)", (64, 2)),
                         ("knnk_wgmma f32 pair selection (d 64)", (64, 3)),
                         ("knnk_wgmma f32 (d 576)", (576, 2)),
                         ("knnk_wgmma f32 pair selection (d 576)",
                          (576, 3))],
            "knn_batched": [("knn2_batched", (0,))]}
    for lib, kernels in libs.items():
        fn = getattr(cuda_build.load(lib), f"{lib}_smem_bytes")
        for kernel, which in kernels:
            lines.append(f"  dynamic smem[{lib}] {kernel}: {fn(*which)} "
                         f"bytes a CTA")
    return lines


def profile_calls(torch, fn, calls):
    """torch.profiler's device time (us) and kernel launches per call of
    ``fn`` over ``calls`` calls after a warm-up, in all and by kernel;
    "not measured" when the profiler saw no device activity."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            # "void (anonymous namespace)::knnk_wgmma<10, 3>(CUtensorMap,
            # ...)" -> "knnk_wgmma<10, 3>"
            m = re.search(r"(\w+(<[^()]*>)?)\(", e.key)
            kernels[m.group(1) if m else e.key[:60]] = {
                "launches": e.count / calls,
                "us": e.self_device_time_total / calls}
    if not kernels:
        return {"device_us_per_call": "not measured",
                "launches_per_call": "not measured"}
    return {"device_us_per_call": sum(v["us"] for v in kernels.values()),
            "launches_per_call": sum(v["launches"]
                                     for v in kernels.values()),
            "kernels": kernels}


def kernel_shares(secs, launches, res):
    """Kernels A and B inside their stages: main-path launches x the
    per-call time at the stage's shape (A: 256-pair blocks in
    03_compdist; B: 48-step log periods in 04_prsweep), beside the stage's
    wall seconds."""
    out = {}
    for key, row, stage in (("A", "A256", "03_compdist"),
                            ("B", f"B{STEPS_PER_LOG}", "04_prsweep")):
        dev_s = launches[key] * res[row]["ms"] / 1e3
        out[f"{key} in {stage}"] = dict(
            launches=launches[key], ms_per_call=res[row]["ms"],
            device_s=dev_s, stage_s=secs[stage],
            share=dev_s / secs[stage])
    return out


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
    timed = timer(torch, secs)
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
    # every row against the f32 route on the same patches (blocks of 1,024
    # pairs), by the precision suite's median relative error
    with store(ws.path("dataset", "synsmoke.h5"), "r") as st:
        idx = st.read("Indices")
        patches = st.read("Patches")
    f32 = torch.from_numpy(ws.load_filters()).cuda()
    ref = np.empty_like(d)
    for s0 in range(0, N_PAIRS, 1024):
        pt1, pt2 = (batch_patch_transform(torch.from_numpy(
            patches[idx[s0:s0 + 1024, c]]).cuda()) for c in (0, 2))
        ref[s0:s0 + 1024] = ring_distances(f32, pt1, pt2).cpu().numpy()
    del f32, pt1, pt2
    rel = np.median(np.abs(d - ref) / (np.abs(ref) + 1e-6))
    if not rel < STAGE3_BF16_MEDIAN_REL_ERR:
        raise AssertionError(f"stage-3 bf16 rows: median rel err {rel} "
                             f"against the f32 route (limit "
                             f"{STAGE3_BF16_MEDIAN_REL_ERR})")
    assert len(out["sweep"]) == 256
    assert all(np.isfinite(r["obj"]) for r in out["sweep"])
    with store(out["single"], "r") as st:
        assert st.get_meta("done_iters") == str(N_LOGS * STEPS_PER_LOG
                                                * PR_BATCH)
    assert out["recs"], "no w history row saved under max_dim"
    best = out["ranked"][0]
    assert 0.0 <= best["mean_fpr95"] <= 1.0
    return dict(stage3_median_rel_err_vs_f32=float(rel),
                stage3_rows_vs_f32=int(N_PAIRS),
                best_fpr95=best["mean_fpr95"], best_dim=best["dim"],
                best_model=os.path.basename(best["model"]),
                best_row=best["row"], n_rows_ranked=len(out["recs"]))


def pick_pr_row(torch, ws, out, secs):
    """The PR row stages 7-11 run on: pr_rank's best row at the published
    width, 512 < dim <= 640 (the reference cap; the committed
    E2E_FULL.json winner is 576-D). If no ranked row lies there, the PR
    sweep reruns with twice the log periods, up to 24. Returns (row, the
    best row under the cap whatever its width, log periods)."""
    from opencv_dlco_tpu_torch.parallel.sweep import run_pr_sweep
    from opencv_dlco_tpu_torch.utils.configs import (
        PRLearnConfig, PRSweepGrid)

    n_logs = N_LOGS
    recs = out["recs"]
    timed = timer(torch, secs)
    while True:
        capped = [r for r in ws.pr_rank(recs, top_k=len(recs))
                  if 0 < r["dim"] <= PR_MAX_DIM]
        band = [r for r in capped if r["dim"] > PR_MIN_DIM]
        if band:
            return band[0], capped[0], n_logs
        if n_logs >= 24:
            raise AssertionError(
                f"no ranked PR row with {PR_MIN_DIM} < dim <= {PR_MAX_DIM} "
                f"after {n_logs} log periods; under the cap: "
                f"{sorted({r['dim'] for r in capped})}")
        n_logs *= 2
        base = PRLearnConfig(
            n_iter=n_logs * STEPS_PER_LOG * PR_BATCH, log_step=LOG_STEP,
            batch=PR_BATCH, max_dim=ws.pool_cfg.n_filters * 8,
            sampling="block_fused", split_dtype="bf16",
            matmul_precision="default")
        sweep = timed(f"04_prsweep[{n_logs} logs]", run_pr_sweep, ws,
                      "synsmoke", PRSweepGrid(), base)
        models = sorted({r["model"] for r in sweep})
        recs = timed(f"05_prstats[{n_logs} logs]", ws.prstats, models,
                     {"synsmoke": out["dist"]})


def run_slice2(torch, ws, pr_ref):
    """Stages 7-11 and the evaluation through the entry points a user
    calls; returns facts for the checks and the per-stage seconds."""
    from opencv_dlco_tpu_torch.data.brown import pair_labels
    from opencv_dlco_tpu_torch.data.store import ArtifactStore
    from opencv_dlco_tpu_torch.models.vgg import VGGDescriptor
    from opencv_dlco_tpu_torch.ops.knn import (
        knn_match, mutual_nearest, ratio_test)
    from opencv_dlco_tpu_torch.parallel.sweep import run_pj_sweep
    from opencv_dlco_tpu_torch.pipeline.e2e import _roundtrip_header
    from opencv_dlco_tpu_torch.pipeline.eval import (
        matching_map, verification)
    from opencv_dlco_tpu_torch.utils.configs import (
        PJLearnConfig, PJSweepGrid)

    secs = {}
    timed = timer(torch, secs)
    unproj = timed("07_compunproj", ws.compunproj, "synsmoke", pr_ref)
    sweep_cfg = PJLearnConfig(n_iter=PJ_SWEEP_LOGS * PJ_LOG_STEP,
                              log_step=PJ_LOG_STEP, batch=PJ_BATCH,
                              eigh_mode="psd_ns", ns_iters=24)
    sweep = timed("08_pjsweep", run_pj_sweep, ws, unproj, PJSweepGrid(),
                  sweep_cfg)
    # a (mu, gamma) outside the grid, so its artifact is its own
    single = timed("08_pjlearn", ws.pjlearn, unproj, PJLearnConfig(
        mu=0.0015, gamma=0.3, n_iter=PJ_LOG_STEP, log_step=PJ_LOG_STEP,
        batch=PJ_BATCH, eigh_mode="exact"))
    models = [r["model"] for r in sweep] + [single]
    recs = timed("09_pjstats", ws.pjstats, models, {"synsmoke": unproj})
    exports, winners = {}, {}
    for dim in EXPORT_DIMS:
        ranked = timed(f"10_pj_rank[{dim}]", ws.pj_rank_cross, recs,
                       max_dim=dim)
        if not ranked:
            raise AssertionError(f"no PJ model ranked under {dim}-D; "
                                 f"ranks: {sorted(r['dim'] for r in recs)}")
        winners[dim] = ranked[0]
        path = timed(f"11_export[{dim}]", ws.export, pr_ref,
                     ranked[0]["model"], f"vgg_generated_{dim}.i")
        exports[dim] = _roundtrip_header(path, device="cuda")

    with ArtifactStore(ws.path("dataset", "synsmoke.h5"), "r") as st:
        idx = st.read("Indices")
        patches = st.read("Patches")
    with open(exports[64]["path"]) as fh:
        model = VGGDescriptor.from_header(fh.read(), device="cuda")
    desc = timed("eval_describe", model.describe, patches)
    d1 = desc[torch.from_numpy(idx[:, 0]).long().cuda()]
    d2 = desc[torch.from_numpy(idx[:, 2]).long().cuda()]
    labels = torch.from_numpy(pair_labels(idx)).cuda()
    ver = timed("eval_verification", verification, d1, d2, labels)
    pos = labels == 1
    q, t = d1[pos].contiguous(), d2[pos].contiguous()
    gt = torch.arange(q.shape[0], dtype=torch.int32, device="cuda")
    mm = timed("eval_matching_map", matching_map, q, t, gt, k=10)
    d_2, i_2 = timed("eval_knn2", knn_match, q, t, k=2)
    m_rt, ok_rt = ratio_test(d_2, i_2)
    m_mu, ok_mu = timed("eval_mutual", mutual_nearest, q, t)
    evals = dict(
        n_desc=int(desc.shape[0]), dim=int(desc.shape[1]),
        desc_finite=bool(torch.isfinite(desc).all()),
        fpr95=ver["fpr95"], auc=ver["auc"], matching_map=mm["map"],
        precision_at_1=mm["precision_at_1"], n_queries=mm["n_queries"],
        ratio_matches=int(ok_rt.sum()),
        ratio_correct=int((m_rt == gt).sum()),
        mutual_matches=int(ok_mu.sum()),
        mutual_correct=int((m_mu == gt).sum()))
    return dict(unproj=unproj, sweep=sweep, single=single, recs=recs,
                winners=winners, exports=exports, evals=evals, q=q, t=t,
                i_2=i_2), secs


def check_slice2(torch, np, out):
    from opencv_dlco_tpu_torch.data.store import ArtifactStore as store
    from opencv_dlco_tpu_torch.ops.knn import knn_match
    from opencv_dlco_tpu_torch.ops.knn_fused import knn2_fused, knnk_fused

    with store(out["unproj"], "r") as st:
        d = st.read("Distance")
    assert d.shape[0] == N_PAIRS and d.shape[1] % 8 == 0, d.shape
    assert np.all(np.isfinite(d)), "non-finite unprojected diffs"
    assert len(out["sweep"]) == 45
    for r in out["recs"]:
        assert 0.0 <= r["fpr95"] <= 1.0 and 0.0 <= r["auc"] <= 1.0, r
    with store(out["single"], "r") as st:
        assert st.get_meta("done_iters") == str(PJ_LOG_STEP)
        assert np.all(np.isfinite(st.read("A")))
    for dim, ex in out["exports"].items():
        assert ex["ok"] and ex["pj_in"] == 8 * ex["n_pr"], ex
        assert ex["pj_in"] == d.shape[1] and 0 < ex["dim"] <= dim, ex
    ev = out["evals"]
    assert ev["desc_finite"] and ev["dim"] == out["exports"][64]["dim"]
    assert 0.0 <= ev["fpr95"] <= 1.0 and 0.5 < ev["auc"] <= 1.0, ev
    # the fused 2-NN against the f32 scan path on the same descriptors:
    # bf16 match identity, the kernels' contract
    _, i_s = knn_match(out["q"], out["t"], k=2, fused=False)
    top1 = float((i_s[:, 0] == out["i_2"][:, 0]).float().mean())
    assert top1 >= 0.99, f"fused vs scan top-1 identity {top1}"
    # every kernel call of the evaluation, repeated on its inputs, against
    # the plain version: the 2-NN (F), matching_map's k = 10 (H) and
    # mutual_nearest's two 1-NN directions (F)
    q, t = out["q"], out["t"]
    held = {}
    for what, a, b, k, wrapper in (
            ("knn2", q, t, 2, knn2_fused), ("matching_k10", q, t, 10,
                                            knnk_fused),
            ("mutual_qt", q, t, 1, knn2_fused),
            ("mutual_tq", t, q, 1, knn2_fused)):
        before = wrapper.launches
        got = knn_match(a, b, k=k)
        if wrapper.launches != before + 1:
            raise AssertionError(f"{what}: knn_match did not launch "
                                 f"{wrapper.__name__}")
        held[what] = hold_knn(torch, f"main path {what}", a, b, k, got,
                              bf16=True)
    return dict(unproj_width=int(d.shape[1]),
                pj_ranks=sorted(int(r["dim"]) for r in out["recs"]),
                winners={dim: {"model": os.path.basename(w["model"]),
                               "dim": w["dim"],
                               "fpr95": w["mean_fpr95"]}
                         for dim, w in out["winners"].items()},
                exports={dim: {k: v for k, v in ex.items() if k != "path"}
                         for dim, ex in out["exports"].items()},
                fused_vs_scan_top1=top1,
                kernels_vs_plain={w: {"max_abs_err": e, "tolerance": tol}
                                  for w, (e, tol) in held.items()}, **ev)


def row_err(got, ref):
    """The worst row's relative L2 error of ``got`` against ``ref``."""
    return float(((got - ref).norm(dim=1)
                  / ref.norm(dim=1).clamp_min(1e-30)).max())


def kernel_checks(torch, ws, dist):
    """Each kernel against its plain version at the main path's shapes,
    with times, bounds and the torch.matmul yardstick."""
    from opencv_dlco_tpu_torch.data.store import ArtifactStore
    from opencv_dlco_tpu_torch.ops import fused_rda as fr
    from opencv_dlco_tpu_torch.ops.pair_distance import ring_distances
    from opencv_dlco_tpu_torch.ops.pair_distance_fused import (
        ring_distances_fused, ring_distances_plain, split_bank)
    from opencv_dlco_tpu_torch.ops.patch_transform import (
        batch_patch_transform)
    from opencv_dlco_tpu_torch.utils.configs import PRSweepGrid

    results = {}
    dev = torch.device("cuda")

    # -- A: full bank at a small block of 64 pairs and at the main
    # path's blocks: 256 pairs (Workspace.pair_block, this script's
    # compdist) and 8,192 (pipeline/e2e.py's run_reference_scale)
    with ArtifactStore(ws.path("dataset", "synsmoke.h5"), "r") as st:
        idx = st.read("Indices")
        patches = st.read("Patches")
    f16 = torch.from_numpy(ws.load_filters()).to(dev).to(torch.bfloat16)
    nf, npix = f16.shape
    for b in A_PAIRS:
        pt1 = batch_patch_transform(
            torch.from_numpy(patches[idx[:b, 0]]).to(dev))
        pt2 = batch_patch_transform(
            torch.from_numpy(patches[idx[:b, 2]]).to(dev))
        got = ring_distances_fused(f16, pt1, pt2, bf16=True)
        # the plain version in blocks of 256 pairs (at 8,192 its f32
        # products of the whole block would take ~21 GB)
        err = 0.0
        for s0 in range(0, b, 256):
            ref = ring_distances_plain(f16, pt1[s0:s0 + 256],
                                       pt2[s0:s0 + 256], bf16=True)
            err = max(err, check_close(f"A[{b} pairs]", got[s0:s0 + 256],
                                       ref, TOL_RING))
        del got, ref
        cols = torch.cat([pt1, pt2]).to(torch.bfloat16).transpose(0, 1) \
            .reshape(npix, -1).contiguous()
        bnd, by = bound_ms(nf * npix * 2 + 2 * b * npix * 8 * 4
                           + b * (nf // 8) * 4,
                           2 * 2 * nf * npix * 8 * b, "bf16")
        reps = 10 if b <= 256 else 3
        results[f"A{b}"] = dict(
            name="ring_distances_fused", route="cuda",
            source="opencv_dlco_tpu_torch/csrc/ring_dist.cu",
            replaces="opencv_dlco_tpu/ops/pair_distance_pallas.py:53",
            max_abs_err=err,
            ms=time_ms(torch, lambda: ring_distances_fused(
                f16, pt1, pt2, bf16=True), reps),
            plain_ms=(time_ms(torch, lambda: ring_distances_plain(
                f16, pt1, pt2, bf16=True), 3) if b <= 256 else None),
            bound_ms=bnd, bound_by=by,
            library_ms=time_ms(torch, lambda: torch.matmul(f16, cols), reps),
            shape=f"F {nf}x{npix} bf16, {b} pairs" + (
                "" if b <= 256 else "; plain version held in blocks of 256 "
                "pairs, not timed"))
        del pt1, pt2, cols
        torch.cuda.empty_cache()
    del f16

    # -- A's f32 mode: the bank split once (as _stage3_bank does), the
    # columns split in each call; the plain version (f32, TF32 off) in
    # blocks of 256 pairs
    f32 = torch.from_numpy(ws.load_filters()).to(dev)
    planes = split_bank(f32)
    for b in A_F32_PAIRS:
        pt1, pt2 = (batch_patch_transform(torch.from_numpy(
            patches[idx[:b, c]]).to(dev)) for c in (0, 2))
        got = ring_distances_fused(planes, pt1, pt2)
        err = max(row_err(got[s0:s0 + 256], ring_distances_plain(
            f32, pt1[s0:s0 + 256], pt2[s0:s0 + 256]))
            for s0 in range(0, b, 256))
        if not err <= A_F32_ROW_ERR:
            raise AssertionError(f"A f32[{b} pairs]: worst row's relative "
                                 f"L2 error {err} (limit {A_F32_ROW_ERR})")
        finite = bool(torch.isfinite(got).all())
        del got
        bnd, by = bound_ms(nf * npix * 4 + 2 * b * npix * 8 * 4
                           + b * (nf // 8) * 4,
                           3 * 2 * 2 * nf * npix * 8 * b, "tf32")
        reps = 10 if b <= 256 else 3
        row = dict(
            name="ring_distances_fused (f32 mode)", route="cuda",
            source="opencv_dlco_tpu_torch/csrc/ring_dist.cu",
            replaces="opencv_dlco_tpu/ops/pair_distance_pallas.py:53",
            max_row_rel_l2=err, finite=finite,
            ms=time_ms(torch, lambda: ring_distances_fused(
                planes, pt1, pt2), reps),
            plain_ms=(time_ms(torch, lambda: ring_distances_plain(
                f32, pt1, pt2), 3) if b <= 256 else None),
            bound_ms=bnd, bound_by=by,
            bound_ffma_ms=bound_ms(0, 2 * 2 * nf * npix * 8 * b, "f32")[0],
            route_f32_ms=time_ms(torch, lambda: ring_distances(
                f32, pt1, pt2), 3 if b <= 256 else 1),
            shape=f"F {nf}x{npix} f32 (split once), {b} pairs" + (
                "" if b <= 256 else "; plain version held in blocks of 256 "
                "pairs, not timed"))
        cols = torch.cat([pt1, pt2]).transpose(0, 1).reshape(npix, -1) \
            .contiguous()
        row["library_ms"] = time_ms(torch, lambda: torch.matmul(f32, cols),
                                    reps if b <= 256 else 1)
        del cols
        torch.cuda.empty_cache()
        if b > 256:
            row["profiler"] = profile_calls(
                torch, lambda: ring_distances_fused(planes, pt1, pt2), 2)
        results[f"Af32_{b}"] = row
        del pt1, pt2
        torch.cuda.empty_cache()
    del f32, planes

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
    # B's three launches a step: device time by kernel over one 48-step call
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fr.fused_block_train_wide(*args, batch=bt)
        torch.cuda.synchronize()
    phases = {}
    for e in prof.key_averages():
        for k in ("wide_f_wgmma", "wide_gate", "wide_df_wgmma"):
            if k in e.key:
                phases[k] = (phases.get(k, 0.0)
                             + e.self_device_time_total / STEPS_PER_LOG)
    results[f"B{STEPS_PER_LOG}"]["device_us_per_step"] = (
        phases or "not measured")

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
            bytes_per_step=2 * bt * f_dim * 4,
            shape=f"S {s_dim}, F {f_dim}, batch {bt}, f32, "
                  f"{STEPS_PER_LOG} steps")
        results[f"C{s_dim}"].update(narrow_profile(
            torch, lambda: fr.fused_block_train(*args, batch=bt),
            STEPS_PER_LOG))

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
        bytes_per_step=2 * bt * f_dim * 4,
        shape=f"S 8, F {f_dim}, batch {bt}, f32, 1 block")
    results["D"].update(narrow_profile(
        torch, lambda: fr.fused_block_grad(pos32, neg32, w_d, hi, 0,
                                           batch=bt), 1))
    return results


def narrow_profile(torch, fn, n_steps):
    """Kernel C's (or D's) device time a step and its kernel launches a
    call, from torch.profiler over 3 calls."""
    prof = profile_calls(torch, fn, 3)
    if not isinstance(prof["device_us_per_call"], float):
        return dict(device_us_per_step="not measured",
                    launches_per_call="not measured")
    narrow = {k: v for k, v in prof["kernels"].items()
              if k.startswith("narrow_persistent")}
    return dict(device_us_per_step=sum(v["us"] for v in narrow.values())
                / n_steps,
                launches_per_call=sum(v["launches"]
                                      for v in narrow.values()),
                profiler=prof)


KNN_N = 65_536                     # bench_matching's shape (bench.py:737)
KNN_F32_N = 8192
KNN_WIDE_N = 16_384
HINGE_N = 50_000                   # bench.py:318's size


def clustered(torch, n, d, seed, scale=1.0):
    """Realistic-margin descriptors (tests/test_knn_pallas.py:18-28): every
    query is a train row plus 5% noise; the train rows are permuted."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    centres = torch.randn((n, d), generator=g, device="cuda")
    q = centres + 0.05 * torch.randn((n, d), generator=g, device="cuda")
    t = centres[torch.randperm(n, generator=g, device="cuda")]
    return (q * scale).contiguous(), (t * scale).contiguous()


def hold_knn(torch, name, q, t, k, got, bf16, atol_of_mag=False):
    """Hold kernel F's or H's (dists, idx) for q, t against knn_plain on
    the same inputs. f32 mode: indices identical except at near-ties,
    distances rtol/atol 1e-5; with ``atol_of_mag`` the absolute part is
    1e-5 of |q|^2 + |t|^2 (for descriptors whose norms put one f32 ulp of
    that sum near or past 1e-5). bf16 mode (tensor-core f32 accumulation
    vs cuBLAS, in another order): identity >= 0.99 on every one of the k
    columns and of the ratio-test matches, and agreeing entries within
    1e-3 relative plus 1e-5 of |q|^2 + |t|^2 (the magnitude the expanded
    form cancels, whose f32 rounding the two orders differ by). Returns
    (max abs err on agreeing entries, the tolerance met)."""
    from opencv_dlco_tpu_torch.ops.knn import ratio_test
    from opencv_dlco_tpu_torch.ops.knn_fused import knn_plain

    dk, ik = got
    dp, ip = knn_plain(q, t, k, bf16=bf16)
    torch.cuda.synchronize()
    same = ik == ip
    if not bf16:
        atol = 1e-5
        if atol_of_mag:
            atol = 1e-5 * ((q * q).sum(1)[:, None]
                           + (t * t).sum(1)[ip.clamp(min=0).long()])
        err = check_close(name, dk, dp, (1e-5, atol))
        # indices differ only at near-ties (two summation orders of the
        # same f32 distances): the kernel's pick is at the plain list's
        # distance there within the tolerance, and no row repeats an index
        rows, slots = (~same).nonzero(as_tuple=True)
        pick = ik[rows, slots].long()
        qs, ts = q[rows].float(), t[pick.clamp(min=0)].float()
        d_pick = torch.clamp((qs * qs).sum(1) + (ts * ts).sum(1)
                             - 2.0 * (qs * ts).sum(1), min=0.0)
        ref = dp[rows, slots]
        at = atol[rows, slots] if atol_of_mag else atol
        tie = (pick >= 0) & ((d_pick - ref).abs() <= at + 1e-5 * ref.abs())
        srt = ik.sort(dim=1).values
        dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        if not bool(tie.all()) or bool(dup.any()):
            raise AssertionError(
                f"{name}: {int((~tie).sum())} indices differ in f32 mode "
                f"beyond near-ties, {int(dup.sum())} repeated")
        return err, (f"indices identical except {rows.numel()} near-tie swaps "
                     f"of {ik.numel()}, rtol 1e-5, atol 1e-5"
                     + (" (|q|^2+|t|^2)" if atol_of_mag else ""))
    cols = same.float().mean(dim=0)
    rt = 1.0
    if k >= 2:
        mk, _ = ratio_test(dk, ik)
        mp, _ = ratio_test(dp, ip)
        rt = float((mk == mp).float().mean())
    if float(cols.min()) < 0.99 or rt < 0.99:
        raise AssertionError(f"{name}: column identity "
                             f"{[round(float(c), 5) for c in cols]}, "
                             f"ratio-test identity {rt}")
    qb = q.to(torch.bfloat16).float()
    tb = t.to(torch.bfloat16).float()
    mag = (qb * qb).sum(1)[:, None] + (tb * tb).sum(1)[ip.clamp(min=0).long()]
    real = same & (ip >= 0)
    err = torch.where(real, (dk - dp).abs(), torch.zeros_like(dk))
    bad = err > 1e-3 * dp.abs() + 1e-5 * mag
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} agreeing distances "
                             f"outside 1e-3 rel + 1e-5 |q|^2+|t|^2; max abs "
                             f"err {float(err.max())}")
    return float(err.max()), (
        f"column identity >= {float(cols.min()):.5f}, ratio-test identity "
        f"{rt:.5f}, agreeing distances within 1e-3 rel + 1e-5 (|q|^2+|t|^2)")


def knn_bound(n, m, d, k, bf16):
    """Kernel F's or H's bound: the inputs read once (bf16 or f32), the
    outputs written once, the products (bf16: one pass at the bf16 peak;
    f32: the least the card takes at f32 accuracy, three tf32 passes at
    the tf32 peak) and knn_topk.cu's ~3 CUDA-core instructions a candidate
    (an add, an fma, a min). Returns (ms, what bounds it, and in f32 the
    bound of one f32 FFMA pass beside it)."""
    n_bytes = (n + m) * d * (2 if bf16 else 4) + n * k * 8
    ops, kind = (2 * n * m * d, "bf16") if bf16 else (6 * n * m * d, "tf32")
    bnd, by = bound_ms(n_bytes, ops, kind, f32_instr=3 * n * m)
    ffma = None if bf16 else bound_ms(n_bytes, 2 * n * m * d, "f32",
                                      f32_instr=3 * n * m)[0]
    return bnd, by, ffma


def knn_row(torch, name, fn, k, n, d, bf16, seed, profile=False):
    """One kernel-vs-plain check of F or H with its times and bound; with
    ``profile``, the kernel's and the library call's device time and
    launches per call from torch.profiler."""
    from opencv_dlco_tpu_torch.ops.knn_fused import knn_plain

    # f32 mode on unit-norm descriptors: one f32 rounding of
    # |q|^2 + |t|^2 is then ~1e-7, below the 1e-5 tolerance
    q, t = clustered(torch, n, d, seed, scale=1.0 if bf16 else d ** -0.5)
    err, tol = hold_knn(torch, name, q, t, k, fn(q, t, bf16=bf16), bf16)
    bnd, by, ffma = knn_bound(n, n, d, k, bf16)
    dt = torch.bfloat16 if bf16 else torch.float32
    qc, tc = q.to(dt), t.to(dt)
    row = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: fn(q, t, bf16=bf16), 5),
        plain_ms=time_ms(torch, lambda: knn_plain(q, t, k, bf16=bf16), 1),
        bound_ms=bnd, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.matmul(qc, tc.T), 5),
        shape=f"{n} x {n}, d {d}, k {k}, {'bf16' if bf16 else 'f32'}",
        tolerance=tol)
    if not bf16:
        row["bound_ffma_ms"] = ffma
    if profile:
        row["profiler"] = profile_calls(torch, lambda: fn(q, t, bf16=bf16), 3)
        row["profiler"]["library"] = profile_calls(
            torch, lambda: torch.matmul(qc, tc.T), 3)
    del q, t, qc, tc
    torch.cuda.empty_cache()
    return row


def knn_call_row(torch, q, t, k, shape, held):
    """Kernel F (k <= 2) or H on the inputs a phase gave it: its times,
    bound, one torch.matmul of the same bf16 product, and its and the
    matmul's device time and launches per call; ``held`` is the phase's
    (max abs err, tolerance) against the plain version."""
    from opencv_dlco_tpu_torch.ops.knn_fused import (
        knn2_fused, knn_plain, knnk_fused)

    if k <= 2:
        name, line = "knn2_fused", 69

        def run():
            return knn2_fused(q, t)
    else:
        name, line = "knnk_fused", 110

        def run():
            return knnk_fused(q, t, k)
    n, d = q.shape
    bnd, by, _ = knn_bound(n, t.shape[0], d, k, True)
    qc, tc = q.to(torch.bfloat16), t.to(torch.bfloat16)
    prof = profile_calls(torch, run, 10)
    prof["library"] = profile_calls(torch, lambda: torch.matmul(qc, tc.T), 10)
    return dict(
        name=name, route="cuda",
        source="opencv_dlco_tpu_torch/csrc/knn_topk.cu",
        replaces=f"opencv_dlco_tpu/ops/knn_pallas.py:{line}",
        max_abs_err=held[0], ms=time_ms(torch, run, 20),
        plain_ms=time_ms(torch, lambda: knn_plain(q, t, k, bf16=True), 5),
        bound_ms=bnd, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.matmul(qc, tc.T), 20),
        shape=shape, tolerance=held[1], profiler=prof)


def f_eval_row(torch, q, t):
    """Kernel F on the evaluation's own descriptors (the 64-D export on the
    smoke's positive pairs, as phase 3's ratio test calls it), against its
    plain version, with its times, bound, matmul yardstick and device time
    and launches per call."""
    from opencv_dlco_tpu_torch.ops.knn_fused import knn2_fused

    n, d = q.shape
    held = hold_knn(torch, "F[evaluation]", q, t, 2, knn2_fused(q, t), True)
    return knn_call_row(torch, q, t, 2, f"{n} x {t.shape[0]}, d {d}, k 2, "
                        f"bf16 (the evaluation's descriptors)", held)


def exact_dev(torch, q, t, got):
    """The largest |dist - exact| over the listed entries of a kNN result,
    exact = |q - t|^2 in f64 at the listed index: how far an f32 route
    lies from the true distances it reports."""
    d, i = got
    real = i >= 0
    rows = torch.arange(q.shape[0], device=q.device)[:, None].expand_as(i)
    ex = ((q[rows[real]].double() - t[i[real].long()].double()) ** 2).sum(1)
    return float((d[real].double() - ex).abs().max())


def f32_eval_row(torch, q, t):
    """The evaluation's 2-NN at HIGHEST parity (knn_match(precision=
    "highest"): kernel F's f32 mode) on the evaluation's own descriptors,
    held by hold_knn's f32 rule with the absolute part 1e-5 of
    |q|^2 + |t|^2: these descriptors' |q|^2 is ~40, and the plain version
    itself lies up to ~3e-5 from the exact (f64) distances, so a flat 1e-5
    would hold the kernel to cuBLAS's summation order. Reports both
    routes' largest deviation from the exact distances, with the times,
    bound, the f32 matmul yardstick (TF32 off) and device time and
    launches per call."""
    from opencv_dlco_tpu_torch.ops.knn import knn_match
    from opencv_dlco_tpu_torch.ops.knn_fused import knn2_fused, knn_plain

    n, d = q.shape
    m = t.shape[0]

    def run():
        return knn_match(q, t, k=2, precision="highest")

    before = knn2_fused.launches
    got = run()
    if knn2_fused.launches != before + 1:
        raise AssertionError("knn_match(precision='highest') did not launch "
                             "knn2_fused")
    plain = knn_plain(q, t, 2, bf16=False)
    vs_exact = dict(kernel=exact_dev(torch, q, t, got),
                    plain=exact_dev(torch, q, t, plain))
    err, tol = hold_knn(torch, "F[evaluation, f32]", q, t, 2, got, False,
                        atol_of_mag=True)
    bnd, by, ffma = knn_bound(n, m, d, 2, False)
    prof = profile_calls(torch, run, 10)
    prof["library"] = profile_calls(torch, lambda: torch.matmul(q, t.T), 10)
    return dict(
        name="knn2_fused", route="cuda",
        source="opencv_dlco_tpu_torch/csrc/knn_topk.cu",
        replaces="opencv_dlco_tpu/ops/knn_pallas.py:69", max_abs_err=err,
        ms=time_ms(torch, run, 20),
        plain_ms=time_ms(torch, lambda: knn_plain(q, t, 2, bf16=False), 5),
        bound_ms=bnd, bound_by=by, bound_ffma_ms=ffma,
        library_ms=time_ms(torch, lambda: torch.matmul(q, t.T), 20),
        shape=f"{n} x {m}, d {d}, k 2, f32 (the evaluation's descriptors, "
              f"precision='highest')",
        tolerance=tol, max_abs_dev_from_exact=vs_exact, profiler=prof)


def sm_clock_under(torch, fn):
    """The SM clock (MHz) nvidia-smi reads while calls of ``fn`` keep the
    card busy (queued from this thread until the reading is in)."""
    import threading

    reading = []

    def query():
        time.sleep(0.3)
        reading.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout)

    fn()
    torch.cuda.synchronize()
    th = threading.Thread(target=query)
    th.start()
    while th.is_alive():
        fn()
    torch.cuda.synchronize()
    return float(reading[0].split()[0])


def e_row(torch, n):
    """Kernel E at P = N = n against its plain version and the sorted
    form: totals within rel 1e-5 (f32 sums of n^2 terms in three orders),
    per-positive partials within rel 1e-5 (sums of non-negative terms),
    and the same bits over two calls (the slices combine in a fixed
    order)."""
    from opencv_dlco_tpu_torch.ops import cuda_build, hinge

    g = torch.Generator(device="cuda").manual_seed(5)
    pos = 1.0 + 0.6 * torch.randn(n, generator=g, device="cuda")
    neg = 2.0 + 0.8 * torch.randn(n, generator=g, device="cuda")
    got = hinge.hinge_sum_blockwise(pos, neg)
    again = hinge.hinge_sum_blockwise(pos, neg)
    part = hinge.hinge_partials(pos, neg)
    ref_part = hinge.hinge_partials_plain(pos, neg)
    ref = float(ref_part.sum())
    srt = float(hinge.hinge_sum_sorted(pos, neg))
    if again.cpu().numpy().tobytes() != got.cpu().numpy().tobytes():
        raise AssertionError(f"E[{n}]: two calls differ: {float(got)!r} vs "
                             f"{float(again)!r}")
    got = float(got)
    for what, r in (("plain", ref), ("sorted", srt)):
        if abs(got - r) > 1e-5 * abs(r):
            raise AssertionError(f"E[{n}] vs {what}: {got} vs {r}")
    check_close(f"E[{n}] partials", part, ref_part, (1e-5, 0.0))
    # per pair a subtract and an add on the FP32 pipe and a max on the
    # min/max rate (no FMA among them); the slower of the two pipes bounds
    pairs = n * n
    t_ops = max(2 * pairs / F32_INSTR_PER_S, pairs / MINMAX_INSTR_PER_S)
    t_bytes = 3 * n * 4 / HBM_BYTES_PER_S
    bnd = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"

    def run():
        return hinge.hinge_sum_blockwise(pos, neg)

    ms = time_ms(torch, run, 20)
    mhz = sm_clock_under(torch, run) if n == HINGE_N else None
    # three warp instructions a term, one issued per scheduler per clock
    issue = 3 * pairs / 32 / (132 * 4)
    return dict(
        name="hinge_sum_blockwise", route="cuda",
        source="opencv_dlco_tpu_torch/csrc/hinge.cu",
        replaces="opencv_dlco_tpu/ops/hinge.py:49",
        max_abs_err=abs(got - ref),
        max_rel_err=float(((part - ref_part).abs()
                           / ref_part.abs().clamp(min=1e-30)).max()),
        ms=ms,
        plain_ms=time_ms(torch, lambda: hinge.hinge_partials_plain(
            pos, neg).sum(), 2),
        bound_ms=bnd, bound_by=by, library_ms=None,
        sorted_ms=time_ms(torch, lambda: hinge.hinge_sum_sorted(pos, neg),
                          20),
        issue_floor_ms=issue / 1.98e9 * 1e3,
        sm_mhz_under_load=mhz,
        issue_floor_at_that_clock_ms=issue / (mhz * 1e6) * 1e3 if mhz
        else None,
        slices=cuda_build.load("hinge").hinge_slices(n, n),
        profiler=profile_calls(torch, run, 20),
        shape=f"P = N = {n}, f32",
        tolerance=f"total rel 1e-5 vs plain and sorted (sorted {srt}); "
                  f"partials rel 1e-5; two calls bit-identical")


def kernel_checks_2(torch):
    """E, F and H against their plain versions on the card, with times,
    bounds and yardsticks (E: the sorted form, no single library call
    computes the all-pairs hinge; F, H: the q.t^T product in torch.matmul)."""
    from opencv_dlco_tpu_torch.ops.knn_fused import knn2_fused, knnk_fused

    results = {"E": e_row(torch, HINGE_N), "E8192": e_row(torch, 8192)}

    def knnk10(q, t, bf16):
        return knnk_fused(q, t, 10, bf16=bf16)

    # F and H run csrc/knn_topk.cu in both modes (F: its pair selection)
    for key, name, fn, k, line in (
            ("F", "knn2_fused", knn2_fused, 2, 69),
            ("H", "knnk_fused", knnk10, 10, 110)):
        base = dict(name=name, route="cuda",
                    source="opencv_dlco_tpu_torch/csrc/knn_topk.cu",
                    replaces=f"opencv_dlco_tpu/ops/knn_pallas.py:{line}")
        for d in (64, 128):
            results[f"{key}{d}"] = dict(base, **knn_row(
                torch, f"{key}[d={d}]", fn, k, KNN_N, d, True, seed=d + k,
                profile=d == 64))
        results[f"{key}f32"] = dict(base, **knn_row(
            torch, f"{key}[f32]", fn, k, KNN_F32_N, 64, False, seed=k,
            profile=True))
        # the 120-D export's width and widths past one D chunk (bf16 600:
        # 10 chunks of 64; f32 576: 18 chunks of 32, queries streamed)
        results[f"{key}120"] = dict(base, **knn_row(
            torch, f"{key}[d=120]", fn, k, KNN_WIDE_N, 120, True, seed=k))
        results[f"{key}600"] = dict(base, **knn_row(
            torch, f"{key}[d=600]", fn, k, KNN_F32_N, 600, True, seed=k))
        results[f"{key}f32_576"] = dict(base, **knn_row(
            torch, f"{key}[f32, d=576]", fn, k, KNN_F32_N, 576, False,
            seed=k, profile=True))
    return results


# -- stage 1 on the card, the SIFT baseline and two-view SfM -----------------

GEN_N = 1024                       # tests/test_data.py:120's draw
DATASET_SEED = 11


def gen_stats(np, p1, p2, labels):
    d = np.abs(p1.astype(np.float32) - p2.astype(np.float32))
    return (float(p1.mean()), float(p1.std()), float(d[labels == 1].mean()),
            float(d[labels == 0].mean()))


def hold_generator(torch, np, ws):
    """The card's pair generator against the numpy route: one 1,024-pair
    draw at HARD_PAIR_PARAMS held by tests/test_data.py:109-140's gates
    (mean within 5%, std within 8%, the pos/neg mean-abs-diff ratio within
    0.1 with pos < neg in both, labels equal), two draws from one seed
    bit-identical, and stage 1's first chunk drawn again from its seed
    bit-identical to the dataset's rows."""
    from opencv_dlco_tpu_torch.data.store import ArtifactStore
    from opencv_dlco_tpu_torch.data.synthetic import (
        HARD_PAIR_PARAMS, synth_patch_pairs, synth_patch_pairs_device)

    def draw(n, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return synth_patch_pairs_device(n, generator=g, device="cuda",
                                        **HARD_PAIR_PARAMS)

    a, b = draw(GEN_N, 7), draw(GEN_N, 7)
    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("generator: two draws from one seed differ")
    ref = synth_patch_pairs(np.random.default_rng(7), n_pairs=GEN_N,
                            **HARD_PAIR_PARAMS)
    am, asd, apos, aneg = gen_stats(np, *ref)
    bm, bsd, bpos, bneg = gen_stats(np, *a)
    gates = dict(labels_equal=bool(np.array_equal(ref[2], a[2])),
                 mean=abs(am - bm) < 0.05 * am,
                 std=abs(asd - bsd) < 0.08 * asd,
                 pos_below_neg=apos < aneg and bpos < bneg,
                 ratio=abs(apos / aneg - bpos / bneg) < 0.1)
    facts = dict(numpy=dict(mean=am, std=asd, pos_over_neg=apos / aneg),
                 card=dict(mean=bm, std=bsd, pos_over_neg=bpos / bneg),
                 gates=gates, same_bits_two_draws=True)
    if not all(gates.values()):
        raise AssertionError(f"generator gates: {facts}")
    chunk = draw(4096, DATASET_SEED * 1_000_003)
    with ArtifactStore(ws.path("dataset", "synsmoke.h5"), "r") as st:
        patches = st.read("Patches")
        idx = st.read("Indices")
    same = (np.array_equal(patches[:4096], chunk[0])
            and np.array_equal(patches[N_PAIRS:N_PAIRS + 4096], chunk[1])
            and np.array_equal(idx[:4096, 1] == idx[:4096, 3],
                               chunk[2] == 1))
    if not same:
        raise AssertionError("stage 1's first chunk differs from a redraw "
                             "from its seed")
    facts["stage1_chunk0_redraw_same_bits"] = True
    return facts


def run_sift_phase(torch, ws, header_path):
    """BASELINE config 3 on the smoke's 16,384 patches: the exported 64-D
    cap's descriptor and the SIFT baseline (ops/sift.py on the card)
    through the same evaluation (verification FPR95/AUC over the 8,192
    pairs, matching mAP at k = 10 (H) and the 2-NN ratio test (F) over
    the positive pairs). Returns both rows, the seconds, and SIFT's
    matching inputs with a slice of the patches for the holds."""
    from opencv_dlco_tpu_torch.data.brown import pair_labels
    from opencv_dlco_tpu_torch.data.store import ArtifactStore
    from opencv_dlco_tpu_torch.models.vgg import VGGDescriptor
    from opencv_dlco_tpu_torch.ops.knn import knn_match, ratio_test
    from opencv_dlco_tpu_torch.ops.sift import sift_describe
    from opencv_dlco_tpu_torch.pipeline.eval import (
        matching_map, verification)

    with ArtifactStore(ws.path("dataset", "synsmoke.h5"), "r") as st:
        idx = st.read("Indices")
        patches = st.read("Patches")
    with open(header_path) as fh:
        model = VGGDescriptor.from_header(fh.read(), device="cuda")
    i1 = torch.from_numpy(idx[:, 0]).long().cuda()
    i2 = torch.from_numpy(idx[:, 2]).long().cuda()
    labels = torch.from_numpy(pair_labels(idx)).cuda()
    pos = labels == 1
    secs, rows = {}, {}
    timed = timer(torch, secs)
    for name, describe in (
            ("dlco", model.describe),
            ("sift", lambda p: sift_describe(p, device="cuda"))):
        desc = timed(f"{name}_describe", describe, patches)
        d1, d2 = desc[i1], desc[i2]
        ver = timed(f"{name}_verification", verification, d1, d2, labels)
        q, t = d1[pos].contiguous(), d2[pos].contiguous()
        gt = torch.arange(q.shape[0], dtype=torch.int32, device="cuda")
        mm = timed(f"{name}_matching_map", matching_map, q, t, gt, k=10)
        d_2, i_2 = timed(f"{name}_knn2", knn_match, q, t, k=2)
        m_rt, ok_rt = ratio_test(d_2, i_2)
        rows[name] = dict(
            dim=int(desc.shape[1]),
            desc_finite=bool(torch.isfinite(desc).all()),
            fpr95=ver["fpr95"], auc=ver["auc"], matching_map=mm["map"],
            precision_at_1=mm["precision_at_1"], n_queries=mm["n_queries"],
            ratio_matches=int(ok_rt.sum()),
            ratio_correct=int((m_rt == gt).sum()))
    return rows, secs, (q, t, patches[:2048])


def check_sift_phase(torch, np, inputs):
    """sift_describe on the card against the same function on the CPU
    (2,048 patches, abs 1e-5, TF32 off), then kernel H's (k = 10) and F's
    (k = 2) calls on the SIFT descriptors repeated through knn_match and
    held against the plain version; returns the facts and H's row."""
    from opencv_dlco_tpu_torch.ops.knn import knn_match
    from opencv_dlco_tpu_torch.ops.knn_fused import knn2_fused, knnk_fused
    from opencv_dlco_tpu_torch.ops.sift import sift_describe

    q, t, sub = inputs
    got = sift_describe(sub, device="cuda").cpu()
    ref = sift_describe(sub, device="cpu")
    err = check_close("sift_describe card vs CPU", got, ref, (0.0, 1e-5))
    facts = dict(sift_card_vs_cpu=dict(max_abs_err=err, n_patches=len(sub),
                                       tolerance="abs 1e-5"))
    held = {}
    for what, k, wrapper in (("matching_k10", 10, knnk_fused),
                             ("knn2", 2, knn2_fused)):
        before = wrapper.launches
        out = knn_match(q, t, k=k)
        if wrapper.launches != before + 1:
            raise AssertionError(f"SIFT {what}: knn_match did not launch "
                                 f"{wrapper.__name__}")
        held[what] = hold_knn(torch, f"SIFT {what}", q, t, k, out, bf16=True)
    facts["kernels_vs_plain"] = {w: {"max_abs_err": e, "tolerance": tol}
                                 for w, (e, tol) in held.items()}
    n, d = q.shape
    row = knn_call_row(torch, q, t, 10,
                       f"{n} x {t.shape[0]}, d {d}, k 10, bf16 (the SIFT "
                       f"baseline's matching mAP)", held["matching_k10"])
    return facts, row


SFM_SEED, SFM_F, SFM_C, SFM_SIZE, SFM_POINTS = 2215, 300.0, 160.0, 320, 220
#: two_view_sfm's defaults, which the sfm command runs
SFM_SETTINGS = dict(n_keypoints=512, ratio=0.85, ransac_iters=1024,
                    ransac_thresh=1e-5, ba_iters=12)


def render_3d_blobs(np, pts3d, amps, sigma_px, f, c, size, r=None, t=None):
    """tests/test_sfm.py's splatter: Gaussian blobs at the projections of
    3D points, seen from (r, t)."""
    if r is not None:
        pts3d = pts3d @ np.asarray(r).T + np.asarray(t)
    u = f * pts3d[:, 0] / pts3d[:, 2] + c
    v = f * pts3d[:, 1] / pts3d[:, 2] + c
    yy, xx = np.mgrid[:size, :size].astype(np.float64)
    img = np.zeros((size, size))
    for ui, vi, a, s in zip(u, v, amps, sigma_px):
        if -10 < ui < size + 10 and -10 < vi < size + 10:
            img += a * np.exp(-((yy - vi) ** 2 + (xx - ui) ** 2)
                              / (2 * s ** 2))
    img = (img - img.min()) / (img.max() - img.min() + 1e-12)
    return (img * 255).astype(np.uint8)


def sfm_scene(torch, np):
    """tests/test_sfm.py:77-91's two views: 220 blobs, f 300, c 160,
    320 px, rotation so3_exp([0.02, -0.03, 0.01]), t [0.3, 0.1, 0.02]."""
    from opencv_dlco_tpu_torch.geometry.se3 import so3_exp

    rng = np.random.default_rng(SFM_SEED)
    n = SFM_POINTS
    pts3d = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                      rng.uniform(4, 9, n)], 1)
    amps = rng.uniform(0.4, 1.0, n) * rng.choice([-1, 1], n)
    sigmas = rng.uniform(2.0, 4.0, n)
    r = so3_exp(torch.tensor([0.02, -0.03, 0.01])).numpy()
    t = np.array([0.3, 0.1, 0.02])
    img1 = render_3d_blobs(np, pts3d, amps, sigmas, SFM_F, SFM_C, SFM_SIZE)
    img2 = render_3d_blobs(np, pts3d, amps, sigmas, SFM_F, SFM_C, SFM_SIZE,
                           r=r, t=t)
    return img1, img2, r, t


def run_sfm_phase(torch, np, header_path, work_dir):
    """The sfm command in-process on the scene written as 8-bit BMPs, with
    the exported 64-D cap's header, twice (cold, then warm); kernel F's
    call site in knn_match records its inputs and outputs. Returns the
    facts, the seconds and the first call's F inputs and outputs."""
    import io

    from opencv_dlco_tpu_torch import cli
    from opencv_dlco_tpu_torch.ops import knn

    img1, img2, r, t = sfm_scene(torch, np)
    os.makedirs(work_dir, exist_ok=True)
    paths = [os.path.join(work_dir, f"view{i}.bmp") for i in (1, 2)]
    for p, img in zip(paths, (img1, img2)):
        write_bmp_gray(p, img)
    argv = ["sfm", "--image1", paths[0], "--image2", paths[1],
            "--model", header_path,
            "--intrinsics", f"{SFM_F},{SFM_F},{SFM_C},{SFM_C}",
            "--keypoints", str(SFM_SETTINGS["n_keypoints"])]
    calls = []
    inner = knn.knn2_fused

    def record(query, train, **kw):
        out = inner(query, train, **kw)
        calls.append((query.clone(), train.clone(), out))
        return out

    secs, outs = {}, []
    knn.knn2_fused = record
    try:
        for run in ("cold", "warm"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(argv)
            torch.cuda.synchronize()
            secs[f"sfm_{run}"] = round(time.perf_counter() - t0, 3)
            outs.append(json.loads(buf.getvalue()))
    finally:
        knn.knn2_fused = inner
    res = outs[0]
    rot = np.asarray(res["rotation"])
    tr = np.asarray(res["translation"])
    if not (np.isfinite(rot).all() and np.isfinite(tr).all()):
        raise AssertionError(f"sfm: non-finite pose {res}")
    if res["n_inliers"] < 8:
        raise AssertionError(f"sfm: {res['n_inliers']} inliers (< 8)")
    if not calls:
        raise AssertionError("sfm: knn_match never called kernel F")
    dr = rot @ r.T
    ang = float(np.degrees(np.arccos(np.clip((np.trace(dr) - 1) / 2,
                                             -1, 1))))
    cos = float(abs(tr @ t / (np.linalg.norm(tr) * np.linalg.norm(t)
                              + 1e-12)))
    gates = dict(n_matches=res["n_matches"] >= 50,
                 n_inliers=res["n_inliers"] >= 40,
                 rms_reproj=res["rms_reproj"] < 5e-3,
                 rotation_deg=ang < 2.0, translation_cos=cos > 0.9)
    facts = dict(n_matches=res["n_matches"], n_inliers=res["n_inliers"],
                 n_points=res["n_points"], rms_reproj=res["rms_reproj"],
                 rotation_err_deg=ang, translation_cos=cos,
                 pose_gates_of_test_sfm=gates,
                 pose_gates_met=all(gates.values()),
                 settings=dict(SFM_SETTINGS, draws="DeviceDraws(0)"),
                 warm_same_result=outs[1] == outs[0],
                 f_calls_per_run=len(calls) // 2)
    return facts, secs, calls[0]


def hold_sfm_f(torch, q, t, got):
    """Kernel F on two-view SfM's inputs (invalid detections at +1e6 in the
    queries, -1e6 in the train rows) against the bf16 plain version: every
    valid query's pair of indices and ratio-test decision equal; every
    distance, masked rows included, within 1e-3 relative plus 1e-5 of
    |q|^2 + |t|^2 (~5e13 on masked rows, whose candidates tie to f32
    resolution: where their indices differ, the kernel's distance still
    lies within that of the plain list's in the same slot)."""
    from opencv_dlco_tpu_torch.ops.knn import ratio_test
    from opencv_dlco_tpu_torch.ops.knn_fused import knn_plain

    dk, ik = got
    dp, ip = knn_plain(q, t, 2, bf16=True)
    torch.cuda.synchronize()
    vq = ~(q == 1e6).all(1)
    if not torch.equal(ik[vq], ip[vq]):
        raise AssertionError(f"F[sfm]: {int((ik[vq] != ip[vq]).sum())} "
                             f"indices of valid queries differ")
    if not torch.equal(ratio_test(dk, ik)[1][vq], ratio_test(dp, ip)[1][vq]):
        raise AssertionError("F[sfm]: ratio-test decisions of valid "
                             "queries differ")
    qb, tb = q.bfloat16().double(), t.bfloat16().double()
    mag = ((qb * qb).sum(1)[:, None]
           + (tb * tb).sum(1)[ip.clamp(min=0).long()])
    err = (dk.double() - dp.double()).abs()
    bad = err > 1e-3 * dp.double().abs() + 1e-5 * mag
    if bool(bad.any()) or bool((ik < 0).any()):
        raise AssertionError(f"F[sfm]: {int(bad.sum())} distances outside "
                             f"1e-3 rel + 1e-5 (|q|^2+|t|^2)")
    swaps = int((ik[~vq] != ip[~vq]).sum())
    return float(err[vq].max()), (
        f"valid queries ({int(vq.sum())} of {q.shape[0]}): indices and "
        f"ratio-test decisions identical, distances within 1e-3 rel + 1e-5 "
        f"(|q|^2+|t|^2); masked queries: distances within the same "
        f"(max abs err {float(err[~vq].max()) if bool((~vq).any()) else 0.0}"
        f", {swaps} tied index swaps)")


SLAM_FRAMES = 48                   # the SLAM bench row (bench_slam)
SLAM_SIZE = 256
SLAM_LONG_FRAMES = 192             # the study's middle length (slam_long)


def ate_over_span(np, translations, centers_gt):
    """ATE RMSE of a trajectory over the ground truth's span."""
    from opencv_dlco_tpu_torch.pipeline.slam import ate_rmse

    span = float(np.linalg.norm(centers_gt.max(0) - centers_gt.min(0)))
    return ate_rmse(translations, centers_gt) / span


def run_slam_path(torch, np, header_path, record):
    """SLAM at the bench row through the entry points bench_slam calls;
    ``record`` wraps kernel G's call site in the pose chunk. Returns facts,
    the per-stage seconds and the inputs of a rerun."""
    from opencv_dlco_tpu_torch.data.synthetic import render_blob_sequence
    from opencv_dlco_tpu_torch.models.vgg import VGGDescriptor
    from opencv_dlco_tpu_torch.pipeline import slam
    from opencv_dlco_tpu_torch.pipeline.slam import (
        SlamConfig, compute_features, run_back_end, run_odometry)

    with open(header_path) as fh:
        header = fh.read()
    model = VGGDescriptor.from_header(header, device="cuda")
    frames, centers_gt, intr = render_blob_sequence(
        np.random.default_rng(2215), SLAM_FRAMES, size=SLAM_SIZE)
    cfg = SlamConfig(n_keypoints=256, kf_min_translation=2.5,
                     kf_min_rotation=0.05, loop_gap=10)
    secs = {}
    timed = timer(torch, secs)
    inner = slam.knn2_fused_batched
    slam.knn2_fused_batched = record(inner)
    try:
        feats = timed("slam_features", compute_features, frames, model, cfg)
        odo = timed("slam_odometry", run_odometry, frames, intr, model, cfg,
                    feats=feats)
        stats = {}
        refined = timed("slam_back_end", run_back_end, odo, feats, intr,
                        cfg, loop_stats=stats)
    finally:
        slam.knn2_fused_batched = inner
    for name, res in (("odometry", odo), ("refined", refined)):
        if not (np.isfinite(res.rotations).all()
                and np.isfinite(res.translations).all()):
            raise AssertionError(f"SLAM {name}: non-finite pose")
        if res.translations.shape != (SLAM_FRAMES, 3):
            raise AssertionError(f"SLAM {name}: trajectory shape "
                                 f"{res.translations.shape}")
    front = secs["slam_features"] + secs["slam_odometry"]
    full = front + secs["slam_back_end"]
    return dict(
        header_sha1=hashlib.sha1(header.encode()).hexdigest()[:12],
        refined_sha1=pose_sha1(refined),
        n_frames=SLAM_FRAMES, size=SLAM_SIZE, n_keypoints=cfg.n_keypoints,
        front_end_fps=SLAM_FRAMES / front, full_stack_fps=SLAM_FRAMES / full,
        n_keyframes=int(refined.keyframes.shape[0]),
        n_loop_closures=len(refined.loop_edges),
        loop_edges=[(int(e[0]), int(e[1])) for e in refined.loop_edges],
        loop_stats=stats,
        backbone_stride=(int(np.median(np.diff(odo.nodes)))
                         if odo.nodes is not None else 1),
        ate_over_span_odometry=ate_over_span(np, odo.translations,
                                             centers_gt),
        ate_over_span=ate_over_span(np, refined.translations, centers_gt),
        valid_keypoints_mean=float(np.mean([f[2].sum() for f in feats])),
        matches_mean=float(np.mean([p.n_matches for p in odo.pairs])),
        inliers_mean=float(np.mean([p.n_inliers for p in odo.pairs]))), \
        secs, (frames, intr, model, cfg, centers_gt)


def pose_sha1(res):
    """A hash of a trajectory's poses, bit for bit."""
    return hashlib.sha1(res.rotations.tobytes()
                        + res.translations.tobytes()).hexdigest()[:12]


def first_forward_ad_seconds(torch):
    """Seconds of the process's first forward-mode Jacobian (the pose
    chunk's BA, MVBA and the pose graphs take theirs by torch.func.jvp),
    on a tiny input: PyTorch's one-time forward-AD set-up."""
    from opencv_dlco_tpu_torch.geometry.jacobian import jac_fwd
    from opencv_dlco_tpu_torch.geometry.se3 import se3_exp, se3_log

    x = torch.zeros((4, 6), device="cuda")
    t0 = time.perf_counter()
    jac_fwd(lambda v: se3_log(*se3_exp(v)), x)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def rerun_slam_path(torch, np, inputs, recorder):
    """bench_slam's steady-state figure: the same calls once more, timed;
    then once more under torch.profiler for the device's busy time and the
    kernel launches (idle share = 1 - busy / the timed run's wall). Each
    run's ATE/span (odometry, refined) and a hash of its refined poses;
    ``recorder(run)`` wraps G's call site in run "steady" and "profiled"."""
    from torch.autograd import DeviceType
    from opencv_dlco_tpu_torch.pipeline import slam
    from opencv_dlco_tpu_torch.pipeline.slam import (
        compute_features, run_back_end, run_odometry)

    frames, intr, model, cfg, centers_gt = inputs
    inner = slam.knn2_fused_batched

    def run(timed, name):
        slam.knn2_fused_batched = recorder(name)(inner)
        try:
            feats = timed("slam_features", compute_features, frames, model,
                          cfg)
            odo = timed("slam_odometry", run_odometry, frames, intr, model,
                        cfg, feats=feats)
            refined = timed("slam_back_end", run_back_end, odo, feats, intr,
                            cfg)
        finally:
            slam.knn2_fused_batched = inner
        return [ate_over_span(np, r.translations, centers_gt)
                for r in (odo, refined)] + [pose_sha1(refined)]

    secs = {}
    ate = {"steady": run(timer(torch, secs), "steady")}
    front = secs["slam_features"] + secs["slam_odometry"]
    wall = front + secs["slam_back_end"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ate["profiled"] = run(timer(torch, {}), "profiled")
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx"))
    return dict(secs, front_end_fps=SLAM_FRAMES / front,
                full_stack_fps=SLAM_FRAMES / wall,
                ate_over_span_odometry_refined=ate,
                device_busy_ms=busy_ms if kernels else "not measured",
                device_idle_share=(1.0 - busy_ms / 1e3 / wall if kernels
                                   else "not measured"),
                kernel_launches=launches,
                top_kernels=[(e.key[:60], e.self_device_time_total / 1e3,
                              e.count) for e in kernels[:5]])


def run_slam_long_phase(torch, np, header_path, record, scene):
    """The SLAM study's (192, 2215) cell through the study tool's
    ``run_cell`` (what ``study_row`` runs: compute_features ->
    run_odometry -> run_back_end at the study's DEFAULT config) with the
    smoke's 64-D header, on ``scene`` (``render_cell(192, 2215)``, drawn
    on the host while earlier phases ran); ``record`` wraps kernel G's
    call site. Fails on a non-finite pose or a trajectory not of shape
    (192, 3). Returns the study row and its seconds."""
    from opencv_dlco_tpu_torch.models.vgg import VGGDescriptor
    from opencv_dlco_tpu_torch.pipeline import slam
    from opencv_dlco_tpu_torch.tools.slam_study import run_cell, study_config

    with open(header_path) as fh:
        model = VGGDescriptor.from_header(fh.read(), device="cuda")
    cfg = study_config()
    inner = slam.knn2_fused_batched
    slam.knn2_fused_batched = record(inner)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row, odo, refined = run_cell(SLAM_LONG_FRAMES, 2215, model, cfg, {},
                                     "cuda", scene=scene)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        slam.knn2_fused_batched = inner
    for name, res in (("odometry", odo), ("refined", refined)):
        if res.translations.shape != (SLAM_LONG_FRAMES, 3):
            raise AssertionError(f"SLAM {SLAM_LONG_FRAMES} {name}: "
                                 f"trajectory shape {res.translations.shape}")
        if not (np.isfinite(res.rotations).all()
                and np.isfinite(res.translations).all()):
            raise AssertionError(f"SLAM {SLAM_LONG_FRAMES} {name}: "
                                 f"non-finite pose")
    return row, secs


def hold_g(torch, name, q, t, got):
    """Kernel G's (dists, idx) for the batch q, t against knn_plain on the
    same inputs, f32: indices identical except at near-ties, where the
    kernel's pick has the plain list's distance within the tolerance;
    distances within 1e-5 relative plus 8 f32 epsilons of |q|^2 + |t|^2
    (the magnitude the expanded form cancels; 1e6-masked rows make it
    ~6e13). Returns (max abs err, max rel err, the tolerance met, the
    near-tie swaps)."""
    from opencv_dlco_tpu_torch.ops.knn_fused import knn_plain

    dk, ik = got
    dp, ip = knn_plain(q, t, 2, bf16=False)
    torch.cuda.synchronize()
    q64, t64 = q.double(), t.double()
    nq, nt = (q64 * q64).sum(-1), (t64 * t64).sum(-1)

    def tol_at(idx, ref):
        mag = nq[..., None] + torch.gather(
            nt[:, None, :].expand(-1, q.shape[1], -1), 2,
            idx.long().clamp(min=0))
        return 1e-5 * ref.double().abs() + 8 * 1.1920929e-07 * mag

    err = (dk.double() - dp.double()).abs()
    if bool((err > tol_at(ip, dp)).any()):
        raise AssertionError(f"{name}: {int((err > tol_at(ip, dp)).sum())} "
                             f"distances outside tolerance, max abs err "
                             f"{float(err.max())}")
    diff = ik != ip
    if bool(diff.any()):
        b, r, s = diff.nonzero(as_tuple=True)
        pick = ik[b, r, s].long()
        d_pick = torch.clamp(nq[b, r] + nt[b, pick]
                             - 2.0 * (q64[b, r] * t64[b, pick]).sum(-1),
                             min=0.0)
        ref = dp[b, r, s].double()
        tol = 1e-5 * ref.abs() + 8 * 1.1920929e-07 * (nq[b, r] + nt[b, pick])
        if not bool(((d_pick - ref).abs() <= tol).all()):
            raise AssertionError(f"{name}: {int(diff.sum())} indices differ "
                                 f"beyond near-ties")
    rel = float((err / dp.double().abs().clamp(min=1e-30)).max())
    return float(err.max()), rel, (
        f"indices identical except {int(diff.sum())} near-tie swaps of "
        f"{ik.numel()}; distances 1e-5 rel + 8 eps (|q|^2+|t|^2)"), \
        int(diff.sum())


def g_row(torch, name, q, t, what):
    """One kernel-vs-plain check of G with its times, bound and the
    batched torch.bmm of q.t^T (TF32 off)."""
    from opencv_dlco_tpu_torch.ops.knn_fused import (
        knn2_fused_batched, knn_plain)

    c, n, d = q.shape
    m = t.shape[1]
    err, rel, tol, _ = hold_g(torch, name, q, t, knn2_fused_batched(q, t))
    bnd, by = bound_ms((c * n * d + c * m * d) * 4 + c * n * 2 * 8,
                       2 * c * n * m * d, "f32", f32_instr=4 * c * n * m)
    tt = t.transpose(1, 2).contiguous()
    prof = profile_calls(torch, lambda: knn2_fused_batched(q, t), 20)
    prof["library"] = profile_calls(torch, lambda: torch.bmm(q, tt), 20)
    return dict(
        name="knn2_fused_batched", route="cuda",
        source="opencv_dlco_tpu_torch/csrc/knn_batched.cu",
        replaces="opencv_dlco_tpu/ops/knn_pallas.py:69",
        max_abs_err=err, max_rel_err=rel,
        ms=time_ms(torch, lambda: knn2_fused_batched(q, t), 20),
        plain_ms=time_ms(torch, lambda: knn_plain(q, t, 2, bf16=False), 5),
        bound_ms=bnd, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.bmm(q, tt), 20),
        shape=f"{c} x {n} x {m}, d {d}, k 2, f32 ({what})", tolerance=tol,
        profiler=prof)


def g_chunks_vs_f32_route(torch, chunks):
    """G on every recorded pose chunk against its plain version (hold_g),
    and against the f32 mode of F's route on the same batches
    (csrc/knn_topk.cu: the 3xTF32 split product and the pair selection):
    how many chunks the two give bit for bit, how many indices differ, the
    largest distance difference, and how many of the pose chunk's
    ratio-test matches the two routes' outputs decide differently; with
    the f32 route's time, device time and launches per call on the first
    chunk."""
    from opencv_dlco_tpu_torch.ops import knn_fused
    from opencv_dlco_tpu_torch.ops.knn import ratio_test
    from opencv_dlco_tpu_torch.pipeline.slam import SlamConfig

    def f32_route(q, t):
        return knn_fused._fused_call(q, t, 2, bf16=False,
                                     wrapper=knn_fused.knn2_fused)

    def matches(d, i):
        return ratio_test(d.reshape(-1, 2), i.reshape(-1, 2),
                          ratio=SlamConfig().ratio)[0]

    same, idx_diff, d_diff, swaps, match_diff = 0, 0, 0.0, 0, 0
    for i, (q, t) in enumerate(chunks):
        dk, ik = knn_fused.knn2_fused_batched(q, t)
        swaps += hold_g(torch, f"G[pose chunk {i}]", q, t, (dk, ik))[3]
        do, io = f32_route(q, t)
        same += int(torch.equal(dk, do) and torch.equal(ik, io))
        idx_diff += int((ik != io).sum())
        d_diff = max(d_diff, float((dk - do).abs().max()))
        match_diff += int((matches(dk, ik) != matches(do, io)).sum())
    q, t = chunks[0]
    return dict(chunks=len(chunks), near_tie_swaps_vs_plain=swaps,
                bit_identical_to_f32_route=same, idx_differing=idx_diff,
                max_abs_dist_diff=d_diff,
                ratio_test_matches_differing=match_diff,
                f32_route_ms=time_ms(torch, lambda: f32_route(q, t), 20),
                f32_route_profiler=profile_calls(
                    torch, lambda: f32_route(q, t), 20))


def kernel_checks_3(torch, chunks):
    """G on the SLAM pose chunks' recorded inputs (the counted run's, at
    the exported descriptor's width; times on the first), and at the bench
    row's nominal 64-D width on descriptors of the same magnitude with the
    same masks (~20% of rows at +-1e6)."""
    q, t = chunks[0]
    rows = {"G": g_row(torch, "G[SLAM chunk]", q, t, "the SLAM pose chunk")}
    rows["G"]["pose_chunks"] = g_chunks_vs_f32_route(torch, chunks)
    c, n, _ = q.shape
    g = torch.Generator(device="cuda").manual_seed(64)
    real = q[q.abs().amax(-1) < 1e5]
    scale = float(real.norm(dim=-1).mean()) * 64 ** -0.5 if real.numel() \
        else 1.0
    q64 = scale * torch.randn((c, n, 64), generator=g, device="cuda")
    t64 = q64[:, torch.randperm(n, generator=g, device="cuda")] + \
        0.05 * scale * torch.randn((c, n, 64), generator=g, device="cuda")
    vq = torch.rand((c, n), generator=g, device="cuda") < 0.8
    vt = torch.rand((c, n), generator=g, device="cuda") < 0.8
    q64 = torch.where(vq[..., None], q64, torch.full_like(q64, 1e6))
    t64 = torch.where(vt[..., None], t64, torch.full_like(t64, -1e6))
    rows["G64"] = g_row(torch, "G[d 64]", q64, t64,
                        "the bench row's 64-D width, synthetic descriptors")
    return rows


# -- the e2e command at a reduced shape --------------------------------------

# two full stage-1 chunks a dataset, both drawn on the card. With one chunk
# (4,096) a dataset holds its positives first, so an all-zero PR row's tied
# distances keep that order and score FPR95 0 in the reference's ROC: the
# degenerate row would rank first
E2E_N_PAIRS = 8192
# 6 log periods of 48 steps: after 3 every iterate is still wider than the
# 640-D cap, so no history row would be saved and nothing could be ranked
E2E_PR_ITERS = 600_000
E2E_PJ_ITERS = 500                 # one PJ log period


def run_e2e_phase(root, name="e2e"):
    """The ``e2e`` command in-process on the card, at a reduced shape:
    the three datasets at 8,192 pairs, 6 PR log periods, one PJ log
    period, the full grids and exports, in the workspace ``root/name``.
    Returns its summary as written to its JSON."""
    from opencv_dlco_tpu_torch import cli

    out_json = os.path.join(root, f"E2E_smoke_{name}.json")
    cli.main(["e2e", "-w", os.path.join(root, name),
              "--n-pairs", str(E2E_N_PAIRS),
              "--pr-iters", str(E2E_PR_ITERS),
              "--pj-iters", str(E2E_PJ_ITERS), "--out-json", out_json])
    with open(out_json) as fh:
        return json.load(fh)


def key_paths(d, prefix=""):
    """Every key path of a nested dict."""
    out = set()
    for k, v in d.items():
        out.add(prefix + str(k))
        if isinstance(v, dict):
            out |= key_paths(v, f"{prefix}{k}/")
    return out


def check_e2e_phase(np, summary, card):
    """The summary has the committed full-scale run's keys at every level,
    the reduced shape, the card's nvidia-smi line as its device, finite
    FPR95s and four exports that are ok."""
    with open(os.path.join(HERE, "E2E_FULL_torch.json")) as fh:
        committed = json.load(fh)
    extra = key_paths(summary) ^ key_paths(committed)
    if extra:
        raise AssertionError(f"e2e summary keys differ from "
                             f"E2E_FULL_torch.json's: {sorted(extra)}")
    want = {"n_pairs": E2E_N_PAIRS, "pr_iters_per_combo": E2E_PR_ITERS,
            "pj_iters_per_combo": E2E_PJ_ITERS, "pr_grid_combos": 256,
            "pj_grid_combos": 45, "n_rings": 5120, "n_filters": 40960,
            "backend": "cuda"}
    want["device"] = card
    got = {k: summary[k] for k in want}
    if got != want:
        raise AssertionError(f"e2e summary: {got} != {want}")
    fprs = [summary["best_pr"]["mean_fpr95"]] + [
        w["mean_fpr95"] for w in summary["pj_winners"].values()]
    if not np.all(np.isfinite(fprs)) or not all(0 < f < 1 for f in fprs):
        raise AssertionError(f"e2e FPR95s {fprs}")
    exports = summary["exports"]
    bad = [cap for cap, rec in exports.items()
           if not rec["ok"] or not 0 < rec["dim"] <= int(cap)]
    if bad or sorted(exports, key=int) != [str(d) for d in EXPORT_DIMS]:
        raise AssertionError(f"e2e exports {exports}")
    return {"best_pr": summary["best_pr"], "pr_ref": summary["pr_ref"],
            "pj_winners": {cap: {k: w[k] for k in ("dim", "mean_fpr95")}
                           for cap, w in summary["pj_winners"].items()},
            "exports": {cap: {k: rec[k] for k in ("n_pr", "dim", "pj_in")}
                        for cap, rec in exports.items()},
            "device": summary["device"],
            "total_wall_seconds": summary["total_wall_seconds"]}


def load_tool(name):
    """``tools/<name>.py`` of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_e2e_bf16_phase(root):
    """The same reduced ``e2e`` run on the bf16 route, through
    tools/e2e_memory_run.py's ``--matmul-precision default`` (its Workspace
    swap) in a fresh workspace; returns the summary and the stage-3 calls
    of each route."""
    tool = load_tool("e2e_memory_run")
    with tool.stage3_precision("default"), tool.stage3_route() as calls:
        summary = run_e2e_phase(root, "e2e_bf16")
    return summary, dict(calls)


def check_e2e_bf16_phase(np, bf16, f32, calls, launches, card):
    """The bf16 run: kernel A once a stage-3 block (and no f32 block),
    the f32 run's checks, and its end metrics within the gates of the f32
    run's."""
    n_blocks = len(bf16["datasets"]) * -(-bf16["n_pairs"] // 8192)
    if (not launches["A"] == calls["kernel_A"] == n_blocks or calls["f32"]
            or calls["kernel_A_f32"] or launches["A_f32"]):
        raise AssertionError(f"bf16 e2e: A launched {launches['A']} times, "
                             f"stage-3 calls {calls}, {n_blocks} blocks")
    facts = check_e2e_phase(np, bf16, card)
    d_pr = abs(bf16["best_pr"]["mean_fpr95"] - f32["best_pr"]["mean_fpr95"])
    d_pj = {cap: abs(w["mean_fpr95"]
                     - f32["pj_winners"][cap]["mean_fpr95"])
            for cap, w in bf16["pj_winners"].items()}
    if d_pr > BEST_PR_FPR95_TOL or max(d_pj.values()) > PJ_FPR95_TOL:
        raise AssertionError(f"bf16 e2e against f32: best PR row "
                             f"|dFPR95| {d_pr} (limit {BEST_PR_FPR95_TOL}), "
                             f"PJ winners {d_pj} (limit {PJ_FPR95_TOL})")
    return {**facts, "stage3_blocks": n_blocks,
            "d_best_pr_fpr95": d_pr, "d_pj_fpr95": d_pj}


# -- the multi-device phase ------------------------------------------------

MD_RANKS = 2                       # ranks on the one card, over gloo
MD_SWEEP_SEED = 2215               # the block offsets of the sweep chunk
SLAM_ATOL = 2e-3                   # two ranks against one device (poses)


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def slam_inputs(np, header_path):
    """The SLAM bench row (run_slam_path's frames, model and config)."""
    from opencv_dlco_tpu_torch.data.synthetic import render_blob_sequence
    from opencv_dlco_tpu_torch.models.vgg import VGGDescriptor
    from opencv_dlco_tpu_torch.pipeline.slam import SlamConfig

    with open(header_path) as fh:
        model = VGGDescriptor.from_header(fh.read(), device="cuda")
    frames, _, intr = render_blob_sequence(np.random.default_rng(2215),
                                           SLAM_FRAMES, size=SLAM_SIZE)
    cfg = SlamConfig(n_keypoints=256, kf_min_translation=2.5,
                     kf_min_rotation=0.05, loop_gap=10)
    return frames, intr, model, cfg


def md_sweep_inputs(torch, ws, dist_path):
    """The PR grid's splits (bf16 on the card), mus, gammas and a zero
    state: the sweep chunk's inputs, from ``dist_path``."""
    from opencv_dlco_tpu_torch.models.pr_rda import pr_init
    from opencv_dlco_tpu_torch.utils.configs import (PRLearnConfig,
                                                     PRSweepGrid)

    base = PRLearnConfig()
    data = ws._load_split(dist_path, base.train_frac, base.seed)
    pos, neg = (torch.from_numpy(data[k]).cuda().to(torch.bfloat16)
                for k in ("pos_trn", "neg_trn"))
    combos = PRSweepGrid().combos()
    mus = torch.tensor([c[0] for c in combos], device="cuda")
    gammas = torch.tensor([c[1] for c in combos], device="cuda")
    return pos, neg, mus, gammas, pr_init(pos.shape[1], len(combos),
                                          device="cuda")


def md_rank_main(rank, work):
    """One of the MD_RANKS processes of phase (b) (``chip_smoke.py
    --multi-rank RANK WORK``): on the one card over gloo, the dry run at
    JAX's (1, 2) mesh, stage 3 sharded over the smoke's dataset, the PR
    sweep chunk over dp 2 and run_slam over a (2, 1) mesh; writes its
    launches, seconds, collective counts and results into ``work``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from opencv_dlco_tpu_torch.ops import fused_rda, knn_fused
    from opencv_dlco_tpu_torch.ops.pair_distance_fused import (
        ring_distances_fused)
    from opencv_dlco_tpu_torch.parallel.distributed import distributed_init
    from opencv_dlco_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                       summary_line)
    from opencv_dlco_tpu_torch.parallel.mesh import make_mesh
    from opencv_dlco_tpu_torch.parallel.sharding import (
        pr_sweep_chunk_sharded)
    from opencv_dlco_tpu_torch.pipeline.slam import run_slam
    from opencv_dlco_tpu_torch.pipeline.stages import Workspace
    from opencv_dlco_tpu_torch.utils.configs import DescriptorConfig

    if not distributed_init(backend="gloo", device="cuda"):
        raise RuntimeError("phase (b): no multi-process group")
    wrappers = {"A": ring_distances_fused,
                "B": fused_rda.fused_block_train_wide,
                "G": knn_fused.knn2_fused_batched}
    calls = {"all_reduce": 0, "all_gather": 0}
    for op in calls:
        inner = getattr(dist, op)

        def counted_op(*a, _op=op, _inner=inner, **kw):
            calls[_op] += 1
            return _inner(*a, **kw)
        setattr(dist, op, counted_op)
    facts = {"rank": rank, "secs": {}, "launches": {}, "collectives": {}}

    def phase(name, fn, *a, **kw):
        for w in wrappers.values():
            w.launches = 0
        for op in calls:
            calls[op] = 0
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        facts["secs"][name] = round(time.perf_counter() - t0, 3)
        facts["launches"][name] = {k: w.launches
                                   for k, w in wrappers.items()}
        facts["collectives"][name] = dict(calls)
        return out

    facts["dryrun"] = summary_line(phase("dryrun", dryrun_multichip,
                                         "cuda"))
    ws = Workspace(os.path.dirname(work), progress=False, pair_block=256,
                   desc_cfg=DescriptorConfig(matmul_precision="default"),
                   device="cuda")
    facts["dist_path"] = phase("compdist", ws.compdist, "synsmoke",
                               sharded=True)
    mesh = make_mesh(dp=MD_RANKS, mp=1, device="cuda")
    pos, neg, mus, gammas, st0 = md_sweep_inputs(torch, ws,
                                                 facts["dist_path"])
    st = phase("sweep_chunk", pr_sweep_chunk_sharded, mesh, pos, neg, mus,
               gammas, st0, torch.Generator().manual_seed(MD_SWEEP_SEED),
               batch=PR_BATCH, n_steps=STEPS_PER_LOG,
               sampling="block_fused", precision="default")
    with open(os.path.join(work, "header.txt")) as fh:
        frames, intr, model, cfg = slam_inputs(np, fh.read())
    res = phase("run_slam", run_slam, frames, intr, model, cfg, mesh=mesh)
    facts["sweep_sha1"] = hashlib.sha1(
        st.w.cpu().numpy().tobytes()
        + st.df_avg.cpu().numpy().tobytes()).hexdigest()[:12]
    facts["refined_sha1"] = pose_sha1(res)
    if rank == 0:
        np.save(os.path.join(work, "sweep_w.npy"), st.w.cpu().numpy())
        np.save(os.path.join(work, "sweep_df.npy"), st.df_avg.cpu().numpy())
        np.save(os.path.join(work, "slam_r.npy"), res.rotations)
        np.save(os.path.join(work, "slam_t.npy"), res.translations)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(facts, fh)
    return 0


def nccl_world_of_one(torch):
    """Phase (a): NCCL at world size 1 in this process, started through
    the port's distributed_init (naming the backend and the coordinator is
    what starts a world of one), make_mesh(1, 1) on the card and the dry
    run; the group is destroyed after, so later phases (and is_primary)
    see none."""
    import torch.distributed as dist
    from opencv_dlco_tpu_torch.parallel.distributed import (
        distributed_init, is_primary)
    from opencv_dlco_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                       summary_line)
    from opencv_dlco_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    if distributed_init(coordinator=f"localhost:{free_port()}",
                        num_processes=1, process_id=0, backend="nccl",
                        device="cuda") or not dist.is_initialized():
        raise AssertionError("distributed_init did not start a world of one")
    try:
        mesh = make_mesh(1, 1, device="cuda")
        x = torch.arange(8.0, device="cuda")
        if not (torch.equal(mesh.psum(x, "dp"), x)
                and torch.equal(mesh.all_gather(x, "mp"), x)):
            raise AssertionError("NCCL world of one: psum/all_gather")
        line = summary_line(dryrun_multichip("cuda"))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    if dist.is_initialized() or not is_primary():
        raise AssertionError("the NCCL group outlived phase (a)")
    return dict(backend=backend, dryrun=line,
                seconds=round(time.perf_counter() - t0, 3))


def run_multi_device_phase(torch, np, ws, dist_h5, header_path):
    """Phase (a), then phase (b): MD_RANKS ranks on the one card over gloo
    (NCCL refuses two ranks on one GPU), each running md_rank_main, while
    this process computes the references: one single-device sweep chunk
    with the same offsets and a single-device run_slam. Fails unless A, B
    and G launched in every rank, the sharded stage-3 matrix equals the
    single-device one bit for bit, the sweep chunk equals the reference
    (bit for bit, or within TOL_BF16, which is reported) and the refined
    poses lie within SLAM_ATOL of the single-device run's."""
    from opencv_dlco_tpu_torch.data.shard_store import ShardedArrayStore
    from opencv_dlco_tpu_torch.data.store import ArtifactStore
    from opencv_dlco_tpu_torch.models.pr_rda import pr_train_chunk
    from opencv_dlco_tpu_torch.pipeline.slam import run_slam

    facts = {"a": nccl_world_of_one(torch)}
    work = os.path.join(ws.root, "multi_device")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "header.txt"), "w") as fh:
        fh.write(header_path)
    port = free_port()
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(MD_RANKS):
            env = dict(os.environ, MASTER_ADDR="localhost",
                       MASTER_PORT=str(port),
                       DLCO_NUM_PROCESSES=str(MD_RANKS),
                       DLCO_PROCESS_ID=str(rank))
            env.pop("DLCO_COORDINATOR", None)
            with open(os.path.join(work, f"rank{rank}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--multi-rank", str(rank), work],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        # the references, while the ranks run
        pos, neg, mus, gammas, st0 = md_sweep_inputs(torch, ws, dist_h5)
        ref = pr_train_chunk(pos, neg, mus, gammas, st0,
                             torch.Generator().manual_seed(MD_SWEEP_SEED),
                             batch=PR_BATCH, n_steps=STEPS_PER_LOG,
                             sampling="block_fused", precision="default")
        ref_w, ref_df = ref.w.cpu().numpy(), ref.df_avg.cpu().numpy()
        del pos, neg, ref
        one = run_slam(*slam_inputs(np, header_path))
        for proc in procs:
            proc.wait(timeout=900)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    facts["b_seconds"] = round(time.perf_counter() - t0, 3)
    bad = [r for r, p in enumerate(procs) if p.returncode]
    if bad:
        with open(os.path.join(work, f"rank{bad[0]}.log")) as fh:
            raise AssertionError(f"phase (b): ranks {bad} failed:\n"
                                 + fh.read()[-6000:])
    ranks = []
    for r in range(MD_RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    facts["ranks"] = ranks
    for rf in ranks:
        for stage, key in (("compdist", "A"), ("sweep_chunk", "B"),
                           ("run_slam", "G")):
            if rf["launches"][stage][key] == 0:
                raise AssertionError(f"rank {rf['rank']}: kernel {key} "
                                     f"never launched in {stage}")
    if len({(rf["sweep_sha1"], rf["refined_sha1"]) for rf in ranks}) != 1:
        raise AssertionError(f"ranks disagree: {ranks}")

    st = ShardedArrayStore(ranks[0]["dist_path"])
    with ArtifactStore(dist_h5, "r") as h5:
        for name in ("Distance", "Label"):
            if not np.array_equal(st.read(name), h5.read(name)):
                raise AssertionError(f"sharded stage 3: {name} differs "
                                     f"from the single-device matrix")
    facts["stage3_bit_equal"] = True

    got_w = torch.from_numpy(np.load(os.path.join(work, "sweep_w.npy")))
    got_df = torch.from_numpy(np.load(os.path.join(work, "sweep_df.npy")))
    facts["sweep_bit_equal"] = bool(np.array_equal(got_w.numpy(), ref_w)
                                    and np.array_equal(got_df.numpy(),
                                                       ref_df))
    facts["sweep_max_abs_err"] = max(
        check_close("sweep chunk w (dp 2 vs one call)", got_w,
                    torch.from_numpy(ref_w), TOL_BF16),
        check_close("sweep chunk df (dp 2 vs one call)", got_df,
                    torch.from_numpy(ref_df), TOL_BF16))

    r2 = np.load(os.path.join(work, "slam_r.npy"))
    t2 = np.load(os.path.join(work, "slam_t.npy"))
    err = max(float(np.abs(r2 - one.rotations).max()),
              float(np.abs(t2 - one.translations).max()))
    facts["slam_max_abs_err_vs_one_device"] = err
    facts["slam_one_device_sha1"] = pose_sha1(one)
    if not (np.isfinite(err) and err <= SLAM_ATOL):
        raise AssertionError(f"two-rank SLAM poses {err} from the "
                             f"single-device run (atol {SLAM_ATOL})")
    return facts


def run_bench_hinge(root):
    """The port's bench through its entry point, suite "hinge" (kernel E
    against the sorted form at P = N = 50,000), on the card; returns the
    details as written to the file."""
    from opencv_dlco_tpu_torch import bench

    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, bench.DEFAULT_OUT)
    bench.run(suite="hinge", out_path=path)
    with open(path) as fh:
        return json.load(fh)


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as err:
        print(f"chip_smoke: {err}", file=sys.stderr)
        return 1
    if len(sys.argv) == 4 and sys.argv[1] == "--multi-rank":
        return md_rank_main(int(sys.argv[2]), sys.argv[3])
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
        from opencv_dlco_tpu_torch.ops import (
            cuda_build, fused_rda, hinge, knn_fused)
        from opencv_dlco_tpu_torch.ops.pair_distance_fused import (
            ring_distances_fused)
        from opencv_dlco_tpu_torch.pipeline.e2e import (
            generate_synthetic_dataset)
        from opencv_dlco_tpu_torch.pipeline.stages import Workspace

        t0 = time.perf_counter()
        cuda_build.build_all()
        print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
        # phase 4a's 192 frames are host work (~30 s of numpy splatting),
        # rendered in a thread while the card runs the phases before it
        from opencv_dlco_tpu_torch.tools.slam_study import render_cell
        render_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        long_scene = render_pool.submit(render_cell, SLAM_LONG_FRAMES, 2215)
        for line in ptxas_summary(cuda_build):
            print(line)

        root = os.path.join(HERE, "workspace_torch_smoke")
        shutil.rmtree(root, ignore_errors=True)
        ws0 = Workspace(root, progress=False, device="cuda")
        t0 = time.perf_counter()
        generate_synthetic_dataset(ws0, "synsmoke", seed=DATASET_SEED,
                                   n_pairs=N_PAIRS)
        dt = time.perf_counter() - t0
        print(f"dataset: {N_PAIRS} synthetic pairs drawn on the card (the "
              f"full 500,000 cut for the time limit), store backend "
              f"{BACKEND}, {dt:.3f}s, {N_PAIRS / dt:.1f} pairs/s",
              flush=True)
        print("generator:", json.dumps(hold_generator(torch, np, ws0)),
              flush=True)

        wrappers = {"A": ring_distances_fused,
                    "B": fused_rda.fused_block_train_wide,
                    "C": fused_rda.fused_block_train,
                    "D": fused_rda.fused_block_grad,
                    "E": hinge.hinge_sum_blockwise,
                    "F": knn_fused.knn2_fused,
                    "G": knn_fused.knn2_fused_batched,
                    "H": knn_fused.knnk_fused}

        def counted(fn, *a):
            """Run one path with every count set to 0 just before it and
            read just after (A: kernel A's bf16 mode, A_f32: its f32
            mode)."""
            for w in wrappers.values():
                w.launches = 0
            ring_distances_fused.launches_f32 = 0
            result = fn(*a)
            return result, {**{k: w.launches for k, w in wrappers.items()},
                            "A_f32": ring_distances_fused.launches_f32}

        # the stages' own log lines (one per step, stat and model row) go
        # to a file; this script prints the summary
        log_dir = os.path.join(HERE, "chiprun_out")
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "chip_smoke_stages.log"), "w") as fh:
            with contextlib.redirect_stdout(fh):
                (ws, out, secs), launches = counted(run_main_path, torch,
                                                    root)
        print("stage seconds:", json.dumps(secs), flush=True)
        print("main-path launches:", json.dumps(launches), flush=True)
        missing = [k for k in "ABC" if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels {missing} never launched on the "
                                 f"main path")
        facts = check_main_path(torch, np, ws, out)
        print("main path:", json.dumps(facts), flush=True)

        # -- stages 7-11 and the evaluation ---------------------------------
        with open(os.path.join(log_dir, "chip_smoke_stages.log"), "a") as fh:
            with contextlib.redirect_stdout(fh):
                pick_secs = {}
                best, best_capped, n_logs = pick_pr_row(torch, ws, out,
                                                        pick_secs)
                pr_ref = f"{best['model']}#{best['row']}"
                (out2, secs2), launches2 = counted(run_slice2, torch, ws,
                                                   pr_ref)
        print(f"PR row for stages 7-11: {os.path.basename(pr_ref)} dim "
              f"{best['dim']} mean FPR95 {best['mean_fpr95']} "
              f"({n_logs} PR log periods); best row under the cap: "
              f"{os.path.basename(best_capped['model'])}#"
              f"{best_capped['row']} dim {best_capped['dim']} mean FPR95 "
              f"{best_capped['mean_fpr95']}", flush=True)
        if pick_secs:
            print("PR reruns:", json.dumps(pick_secs), flush=True)
        print("stage seconds 7-11:", json.dumps(secs2), flush=True)
        print("stages 7-11 launches:", json.dumps(launches2), flush=True)
        missing = [k for k in "FH" if launches2[k] == 0]
        if missing:
            raise AssertionError(f"kernels {missing} never launched on "
                                 f"stages 7-11 and the evaluation")
        facts2 = check_slice2(torch, np, out2)
        print("stages 7-11:", json.dumps(facts2), flush=True)
        header_64 = out2["exports"][64]["path"]
        eval_qt = (out2["q"], out2["t"])
        del out2

        # -- BASELINE config 3: the SIFT baseline against the header ----------
        (sift_rows, sift_secs, sift_inputs), launches5 = counted(
            run_sift_phase, torch, ws, header_64)
        print("SIFT vs DLCO (config 3):", json.dumps(sift_rows), flush=True)
        print("SIFT phase seconds:", json.dumps(sift_secs), flush=True)
        print("SIFT phase launches:", json.dumps(launches5), flush=True)
        missing = [k for k in "FH" if launches5[k] == 0]
        if missing:
            raise AssertionError(f"kernels {missing} never launched in the "
                                 f"SIFT phase")
        sift_facts, h_sift_row = check_sift_phase(torch, np, sift_inputs)
        print("SIFT phase:", json.dumps(sift_facts), flush=True)
        del sift_inputs

        # -- BASELINE config 4: the sfm command on rendered BMPs --------------
        (sfm_facts, sfm_secs, sfm_call), launches6 = counted(
            run_sfm_phase, torch, np, header_64, os.path.join(root, "sfm"))
        print("SfM seconds:", json.dumps(sfm_secs), flush=True)
        print("SfM launches:", json.dumps(launches6), flush=True)
        if launches6["F"] == 0:
            raise AssertionError("kernel F never launched in the sfm command")
        q_s, t_s, got_s = sfm_call
        f_sfm_held = hold_sfm_f(torch, q_s, t_s, got_s)
        sfm_facts["f_vs_plain"] = {"max_abs_err": f_sfm_held[0],
                                   "tolerance": f_sfm_held[1]}
        print("SfM:", json.dumps(sfm_facts), flush=True)
        if not sfm_facts["pose_gates_met"]:
            raise AssertionError(
                "sfm: the pose gates of tests/test_sfm.py:96-106 failed: "
                + json.dumps(sfm_facts["pose_gates_of_test_sfm"]))
        f_sfm_row = knn_call_row(
            torch, q_s, t_s, 2, f"{q_s.shape[0]} x {t_s.shape[0]}, d "
            f"{q_s.shape[1]}, k 2, bf16 (two-view SfM's descriptors, "
            f"invalid rows at +-1e6)", f_sfm_held)
        del sfm_call, q_s, t_s, got_s

        # -- SLAM at the bench row -----------------------------------------
        chunks = []                     # the counted run's G inputs
        g_outputs = {"counted": [], "steady": [], "profiled": []}

        def recorder(run, keep=False):
            """Wraps the pose chunk's G call site: a hash of each output
            goes to g_outputs[run]; with ``keep``, each call's inputs to
            ``chunks``."""
            def record(fn):
                def g(query, train, **kw):
                    if keep:
                        chunks.append((query.clone(), train.clone()))
                    d, i = fn(query, train, **kw)
                    g_outputs[run].append(hashlib.sha1(
                        d.cpu().numpy().tobytes()
                        + i.cpu().numpy().tobytes()).hexdigest()[:8])
                    return d, i
                return g
            return record

        print(f"forward-AD first use: {first_forward_ad_seconds(torch):.3f}s",
              flush=True)
        (facts3, secs3, slam_inputs), launches3 = counted(
            run_slam_path, torch, np, header_64, recorder("counted", True))
        print("SLAM stage seconds:", json.dumps(secs3), flush=True)
        print("SLAM launches:", json.dumps(launches3), flush=True)
        if launches3["G"] == 0:
            raise AssertionError("kernel G never launched on the SLAM path")
        print("SLAM:", json.dumps(facts3), flush=True)

        # -- SLAM at the study's 192 frames (the 32-node backbone floor) ----
        long_chunks = []

        def keep_long(fn):
            def g(query, train, **kw):
                long_chunks.append((query.clone(), train.clone()))
                return fn(query, train, **kw)
            return g

        scene = long_scene.result()
        render_pool.shutdown()
        (long_row, long_secs), launches8 = counted(
            run_slam_long_phase, torch, np, header_64, keep_long, scene)
        del scene
        print(f"SLAM {SLAM_LONG_FRAMES} frames: {long_secs:.3f}s, stride "
              f"{long_row['stride']}, {long_row['n_nodes']} nodes, "
              f"launches {json.dumps(launches8)}", flush=True)
        print(f"SLAM {SLAM_LONG_FRAMES} row:", json.dumps(long_row),
              flush=True)
        if launches8["G"] == 0:
            raise AssertionError(f"kernel G never launched on the "
                                 f"{SLAM_LONG_FRAMES}-frame SLAM path")
        held = [hold_g(torch, f"G[{SLAM_LONG_FRAMES}-frame chunk {i}]", q, t,
                       knn_fused.knn2_fused_batched(q, t))
                for i, (q, t) in enumerate(long_chunks)]
        print(f"SLAM {SLAM_LONG_FRAMES} G vs plain:", json.dumps({
            "chunks": len(held), "max_abs_err": max(h[0] for h in held),
            "near_tie_swaps": sum(h[3] for h in held),
            "tolerance": held[0][2]}), flush=True)
        del long_chunks, held

        # -- the bench entry point, suite "hinge" (kernel E) ---------------
        details, launches4 = counted(run_bench_hinge,
                                     os.path.join(root, "bench"))
        print("bench launches:", json.dumps(launches4), flush=True)
        if launches4["E"] == 0:
            raise AssertionError("kernel E never launched in the bench")
        missing = {"kernel_time", "sorted_time"} - set(details["hinge"])
        if missing:
            raise AssertionError(f"bench hinge details lack {missing}")
        print("bench hinge:", json.dumps(details["hinge"]), flush=True)

        # -- the e2e command at a reduced shape (kernels A and B) ----------
        with open(os.path.join(log_dir, "chip_smoke_stages.log"), "a") as fh:
            with contextlib.redirect_stdout(fh):
                e2e_summary, launches7 = counted(run_e2e_phase, root)
        print("e2e stage seconds:", json.dumps(e2e_summary["stage_seconds"]),
              flush=True)
        print("e2e launches:", json.dumps(launches7), flush=True)
        # stage 3 of the e2e command runs at DescriptorConfig's default
        # precision, "highest", as the JAX package's run_reference_scale
        # does: kernel A's f32 mode, once a block
        if launches7["B"] == 0:
            raise AssertionError("kernel B never launched in the e2e "
                                 "command")
        n_blocks7 = len(e2e_summary["datasets"]) * -(
            -e2e_summary["n_pairs"] // 8192)
        if launches7["A"] or launches7["A_f32"] != n_blocks7:
            raise AssertionError(f"e2e: A launched {launches7['A']} times "
                                 f"in its bf16 mode and {launches7['A_f32']}"
                                 f" in its f32 mode, {n_blocks7} blocks")
        print("e2e:", json.dumps(check_e2e_phase(np, e2e_summary, card)),
              flush=True)
        shutil.rmtree(os.path.join(root, "e2e"), ignore_errors=True)

        # -- the same run on the bf16 route (kernel A in stage 3) ----------
        with open(os.path.join(log_dir, "chip_smoke_stages.log"), "a") as fh:
            with contextlib.redirect_stdout(fh):
                (e2e_bf16, calls9), launches9 = counted(run_e2e_bf16_phase,
                                                        root)
        print("e2e bf16 stage seconds:",
              json.dumps(e2e_bf16["stage_seconds"]), flush=True)
        print("e2e bf16 launches:", json.dumps(launches9), "stage-3 calls:",
              json.dumps(calls9), flush=True)
        print("e2e bf16:", json.dumps(check_e2e_bf16_phase(
            np, e2e_bf16, e2e_summary, calls9, launches9, card)), flush=True)
        shutil.rmtree(os.path.join(root, "e2e_bf16"), ignore_errors=True)

        # the kernels' checks and profiles come before the SLAM profile
        res = kernel_checks(torch, ws, out["dist"])
        res.update(kernel_checks_2(torch))
        res["Feval"] = f_eval_row(torch, *eval_qt)
        res["Feval_f32"] = f32_eval_row(torch, *eval_qt)
        res["Fsfm"] = f_sfm_row
        res["Hsift"] = h_sift_row
        res.update(kernel_checks_3(torch, chunks))
        steady = rerun_slam_path(torch, np, slam_inputs, recorder)
        print("SLAM steady state:", json.dumps(steady), flush=True)
        refined_by_run = {"counted": [facts3["ate_over_span"],
                                      facts3["refined_sha1"]]}
        refined_by_run.update(
            (run, [a[1], a[2]])
            for run, a in steady["ate_over_span_odometry_refined"].items())
        print("SLAM refined ATE/span and poses by run:",
              json.dumps(refined_by_run), flush=True)
        if len({json.dumps(v) for v in refined_by_run.values()}) != 1:
            raise AssertionError(f"SLAM refined trajectory differs between "
                                 f"runs: {refined_by_run}")
        print("SLAM G outputs by run:", json.dumps(g_outputs), flush=True)
        del slam_inputs

        # -- multi-device: NCCL at world size 1, then two gloo ranks -------
        md = run_multi_device_phase(torch, np, ws, out["dist"], header_64)
        print("multi-device (a), NCCL world of one:", json.dumps(md["a"]),
              flush=True)
        for rf in md["ranks"]:
            print(f"multi-device (b) rank {rf['rank']}: "
                  + json.dumps({k: rf[k] for k in (
                      "secs", "launches", "collectives", "sweep_sha1",
                      "refined_sha1", "dryrun")}), flush=True)
        print("multi-device (b):", json.dumps(
            {k: v for k, v in md.items() if k not in ("a", "ranks")}),
            flush=True)
        with open(os.path.join(log_dir, "chip_smoke_multi_device.json"),
                  "w") as fh:
            json.dump({"card": card, **md}, fh, indent=1)
        md_launches = {k: sum(rf["launches"][stage][k]
                              for rf in md["ranks"]
                              for stage in rf["launches"])
                       for k in "ABG"}
        for key, r in res.items():
            print(f"kernel {key}: " + json.dumps(r), flush=True)
        print("kernel shares:", json.dumps(kernel_shares(
            secs, launches, res)), flush=True)
        table = []
        for key, row in (("A", "A256"), ("A_f32", "Af32_8192"),
                         ("B", f"B{STEPS_PER_LOG}"),
                         ("C", "C1"), ("D", "D"), ("E", "E"), ("F", "Feval"),
                         ("G", "G"), ("H", "H64")):
            r = {k: v for k, v in res[row].items()
                 if k not in ("shape", "tolerance", "sorted_ms",
                              "max_rel_err", "device_us_per_step",
                              "issue_floor_ms", "sm_mhz_under_load",
                              "issue_floor_at_that_clock_ms", "slices",
                              "launches_per_call", "bytes_per_step",
                              "profiler", "pose_chunks",
                              "max_row_rel_l2", "finite")}
            table.append({**r, "launches": launches[key] + launches2[key]
                          + launches3[key] + launches4[key]
                          + launches5[key] + launches6[key]
                          + launches7[key] + launches8[key]
                          + launches9[key]
                          + md_launches.get(key, 0)})
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
