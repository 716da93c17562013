"""Split stage 3's (compdist's) seconds a block on an ``e2e`` workspace:
the ring-distance product on the card against the host's work.

    python tools/compdist_profile.py -w <workspace> --ds synlib \
        --blocks 8 --out-json <path> [--matmul-precision default]

The workspace is one the ``e2e`` command wrote (its dataset and filter
bank); stage 3 runs as ``run_reference_scale`` runs it
(``Workspace(pair_block=8192)``), at ``DescriptorConfig``'s default
precision "highest" (kernel A's f32 mode on the card where the bank
fits its tiles) or, with ``--matmul-precision default``, on the bf16
route (kernel A's bf16 mode), the route ``Workspace._stage3_bank``
picks. Three parts, each over the first ``--blocks`` blocks of the
dataset, writing into a scratch artifact of the stage's full shape that
is removed at the end:

1. ``split``: the body of ``Workspace._dist_rows`` a line at a time, the
   card synchronised after each part: the host's patch gather
   (``patches[indices[s:e, c]]``), the upload, the patch transform, the
   ring distances (kernel A with its operand split or layout, or the f32
   product with its truncation and ring sums), the copy to the host, the
   finite check, and ``write_rows`` (the memory map's copy and flush); host
   seconds from ``time.perf_counter``;
2. ``program``: ``Workspace._dist_rows`` itself over the same blocks, timed
   on the host clock (the loop already synchronises on every block's copy
   to the host);
3. ``profiled``: the same call under ``torch.profiler``: the card's busy
   time (the kernels' device time summed), its share of the call's wall
   seconds, and the kernels that take the most device time.

With ``--prepare`` the tool first writes what it needs: the dataset at
the ``e2e`` command's default size and seed and its stage 3
(``compdist``, on the same route), each timed. The patches' and indices'
load (``ArtifactStore.read``, as compdist does) is timed once; each part's
rows are compared with the stage's own output
(``rows_equal_stage_output``: a stage-3 artifact written on the other
route does not compare equal). The JSON names the card from nvidia-smi,
the precision and the route, and each part kernel A's launches in each
mode (``kernel_a_launches``: bf16, ``kernel_a_f32_launches``: f32).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from opencv_dlco_tpu_torch.data.store import (ArtifactStore,  # noqa: E402
                                              remove_artifact)
from opencv_dlco_tpu_torch.pipeline.e2e import (  # noqa: E402
    DEFAULT_DATASETS, REFERENCE_N_PAIRS, generate_synthetic_dataset)
from opencv_dlco_tpu_torch.ops.pair_distance_fused import (  # noqa: E402
    ring_distances_fused)
from opencv_dlco_tpu_torch.ops.patch_transform import (  # noqa: E402
    batch_patch_transform)
from opencv_dlco_tpu_torch.pipeline.stages import (  # noqa: E402
    Workspace, stage3_distances, stage3_route)
from opencv_dlco_tpu_torch.utils.configs import (  # noqa: E402
    DescriptorConfig)

PAIR_BLOCK = 8192            # run_reference_scale's Workspace(pair_block)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


PARTS = ("gather", "upload", "transform", "ring_distances", "to_host",
         "finite_check", "write_rows")


def scratch_store(ws, shape, tag: str):
    """A Distance artifact of the stage's full shape, as compdist creates
    it."""
    path = ws.path("distances", f"_profile_{tag}-dist.h5")
    st = ArtifactStore(path, "w")
    st.create("Distance", shape, np.float32,
              compression=ws.dist_compression)
    return st


def split_blocks(ws, st, indices, patches, n_blocks: int) -> dict:
    """Part 1: _dist_rows' body timed a part at a time."""
    dev = ws._dev
    filters, route = ws._stage3_bank()
    secs = {p: [] for p in PARTS}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        secs[name].append(time.perf_counter() - t0)
        return out

    blk = ws.pair_block
    for s in range(0, n_blocks * blk, blk):
        e = s + blk
        h1, h2 = part("gather", lambda: (patches[indices[s:e, 0]],
                                         patches[indices[s:e, 2]]))
        p1, p2 = part("upload", lambda: (torch.from_numpy(h1).to(dev),
                                         torch.from_numpy(h2).to(dev)))
        pt1, pt2 = part("transform", lambda: (
            batch_patch_transform(p1, ws.desc_cfg),
            batch_patch_transform(p2, ws.desc_cfg)))
        d = part("ring_distances",
                 lambda: stage3_distances(filters, route, pt1, pt2))
        del p1, p2, pt1, pt2
        d = part("to_host", lambda: d.cpu().numpy())
        ok = part("finite_check", lambda: bool(np.all(np.isfinite(d))))
        if not ok:
            raise FloatingPointError(f"rows [{s}, {e}) not finite")
        part("write_rows", lambda: st.write_rows("Distance", s, d))
    total = sum(sum(v) for v in secs.values())
    return {"seconds_per_block": {p: v for p, v in secs.items()},
            "seconds_total": {p: sum(v) for p, v in secs.items()},
            "share": {p: sum(v) / total for p, v in secs.items()},
            "seconds": total}


def profiled_blocks(ws, st, indices, patches, n_blocks: int) -> dict:
    """Part 3: the program's loop under torch.profiler."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU]
    if ws._dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ws._dist_rows(st, indices, patches, 0, n_blocks * ws.pair_block)
        sync(ws._dev)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    return {"wall_seconds": wall,
            "device_busy_seconds": busy if kernels else "not measured",
            "device_busy_share": busy / wall if kernels else "not measured",
            "top_kernels": [[e.key[:80], e.self_device_time_total / 1e6,
                             e.count] for e in kernels[:8]]}


def prepare(ws, ds: str) -> dict:
    """Stage 1 and stage 3 of ``ds`` as the ``e2e`` command runs them
    (each a no-op where it is complete), with their seconds and the
    stage-3 device peak."""
    out = {}
    t0 = time.perf_counter()
    generate_synthetic_dataset(ws, ds, DEFAULT_DATASETS[ds],
                               n_pairs=REFERENCE_N_PAIRS)
    out["generate_seconds"] = time.perf_counter() - t0
    if ws._dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ws._dev)
    ring_distances_fused.launches = ring_distances_fused.launches_f32 = 0
    t0 = time.perf_counter()
    ws.compdist(ds)
    sync(ws._dev)
    out["compdist_seconds"] = time.perf_counter() - t0
    out["compdist_kernel_a_launches"] = ring_distances_fused.launches
    out["compdist_kernel_a_f32_launches"] = ring_distances_fused.launches_f32
    out["compdist_device_peak_bytes"] = (
        torch.cuda.max_memory_allocated(ws._dev)
        if ws._dev.type == "cuda" else None)
    print("compdist_profile prepare:", json.dumps(out), flush=True)
    return out


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-w", "--workspace", required=True)
    ap.add_argument("--ds", default="synlib")
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--pair-block", type=int, default=PAIR_BLOCK)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain path at a toy size")
    ap.add_argument("--prepare", action="store_true",
                    help="first write the dataset (stage 1, at the e2e "
                         "command's default size and seed) and its stage "
                         "3, timed, where the workspace lacks them")
    ap.add_argument("--matmul-precision", choices=("highest", "default"),
                    default="highest",
                    help="stage 3's DescriptorConfig.matmul_precision: "
                         "default takes kernel A")
    ap.add_argument("--out-json", required=True)
    args = ap.parse_args(argv)
    ws = Workspace(args.workspace, pair_block=args.pair_block,
                   progress=False, device=args.device,
                   desc_cfg=DescriptorConfig(
                       matmul_precision=args.matmul_precision))
    prepared = prepare(ws, args.ds) if args.prepare else None
    t0 = time.perf_counter()
    with ArtifactStore(ws.path("dataset", f"{args.ds}.h5"), "r") as st:
        indices = st.read("Indices")
        patches = st.read("Patches")
    load = time.perf_counter() - t0
    with ArtifactStore(ws.dist_path(args.ds), "r") as st:
        shape = st.shape("Distance")              # the stage's output
    n_pairs = indices.shape[0]
    if args.blocks * ws.pair_block > n_pairs:
        raise SystemExit(f"{args.blocks} blocks exceed {n_pairs} pairs")
    out = {"card": card_line(),
           "dataset": args.ds, "n_pairs": int(n_pairs),
           "pair_block": ws.pair_block, "blocks": args.blocks,
           "precision": ws.desc_cfg.matmul_precision,
           "route": stage3_route(ws.desc_cfg.matmul_precision,
                                 ws.load_filters().shape,
                                 ws._dev.type == "cuda"),
           "load_seconds": load, "prepare": prepared}
    paths = []
    try:
        for tag, fn in (("split", split_blocks),
                        ("program", None), ("profiled", profiled_blocks)):
            st = scratch_store(ws, shape, tag)
            paths.append(st.path)
            ring_distances_fused.launches = \
                ring_distances_fused.launches_f32 = 0
            with st:
                if fn is None:
                    t0 = time.perf_counter()
                    ws._dist_rows(st, indices, patches, 0,
                                  args.blocks * ws.pair_block)
                    sync(ws._dev)
                    out[tag] = {"seconds": time.perf_counter() - t0}
                else:
                    out[tag] = fn(ws, st, indices, patches, args.blocks)
            out[tag]["kernel_a_launches"] = ring_distances_fused.launches
            out[tag]["kernel_a_f32_launches"] = \
                ring_distances_fused.launches_f32
            with ArtifactStore(st.path, "r") as got, \
                    ArtifactStore(ws.dist_path(args.ds), "r") as want:
                n = args.blocks * ws.pair_block
                out[tag]["rows_equal_stage_output"] = bool(np.array_equal(
                    got.read("Distance", 0, n), want.read("Distance", 0, n)))
            print(f"compdist_profile {tag}:", json.dumps(out[tag]),
                  flush=True)
    finally:
        for p in paths:
            remove_artifact(p)
    out["device_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if ws._dev.type == "cuda" else None)
    with open(args.out_json, "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
