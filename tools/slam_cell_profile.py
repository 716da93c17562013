"""Profile one cell of the SLAM study on the card.

    python tools/slam_cell_profile.py --header <vgg_generated_64.i> \\
        --scene 512 --seed 2215 [--out-json <path>]

The cell is ``opencv_dlco_tpu_torch.tools.slam_study.run_cell`` at the
study's DEFAULT config: render_blob_sequence(seed, scene frames, 256 px)
through compute_features -> run_odometry -> run_back_end. The process
first runs a 48-frame cell of the same seed (the kernels' build and
PyTorch's first forward-mode Jacobian fall there), renders the cell's
frames once (host work, outside every clock below), then runs the cell
once timed and once under ``torch.profiler`` (CPU and CUDA activities).
It prints one JSON object:

- ``wall_s``: the timed run's host seconds from compute_features to the
  end of run_back_end, the card synchronised at both ends;
  ``wall_profiled_s`` the profiled run's; ``render_s`` the rendering's;
- ``kernel_launches``: the profiled run's CUDA launch calls
  (``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel``,
  ``cuLaunchKernelEx``); ``g_launches``: kernel G's wrapper count in it;
- ``device_busy_s``: the profiled run's summed kernel time, and
  ``device_busy_share`` that over the timed run's wall (``not measured``
  when the profiler saw no device time);
- ``top_kernels``: the five kernels with the most device time (name,
  seconds, calls);
- ``rows``: the timed and the profiled run's study rows (equal but for
  ``wall`` when the path is deterministic), and the card's nvidia-smi
  line.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--header", required=True)
    ap.add_argument("--scene", type=int, default=512)
    ap.add_argument("--seed", type=int, default=2215)
    ap.add_argument("--out-json", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType

    from opencv_dlco_tpu_torch.models.vgg import VGGDescriptor
    from opencv_dlco_tpu_torch.ops.knn_fused import knn2_fused_batched
    from opencv_dlco_tpu_torch.pipeline.e2e import card_description
    from opencv_dlco_tpu_torch.tools.slam_study import (
        render_cell, run_cell, study_config)

    if not torch.cuda.is_available():
        ap.error("CUDA is not available: the profile is of the card")
    dev = torch.device("cuda")
    with open(args.header) as fh:
        model = VGGDescriptor.from_header(fh.read(), device=dev)
    cfg = study_config()

    def cell(n_frames, scene):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row = run_cell(n_frames, args.seed, model, cfg, {}, "cuda",
                       scene=scene)[0]
        torch.cuda.synchronize()
        return row, time.perf_counter() - t0

    cell(48, render_cell(48, args.seed))
    t0 = time.perf_counter()
    scene = render_cell(args.scene, args.seed)
    render_s = time.perf_counter() - t0
    row_timed, wall = cell(args.scene, scene)
    g0 = knn2_fused_batched.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        row_prof, wall_prof = cell(args.scene, scene)
    g_launches = knn2_fused_batched.launches - g0
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    out = {
        "card": card_description(dev),
        "torch": torch.__version__,
        "scene": args.scene, "seed": args.seed,
        "wall_s": wall, "wall_profiled_s": wall_prof, "render_s": render_s,
        "kernel_launches": sum(e.count for e in events
                               if e.key in LAUNCH_CALLS),
        "g_launches": g_launches,
        "device_busy_s": busy if kernels else "not measured",
        "device_busy_share": busy / wall if kernels else "not measured",
        "top_kernels": [(e.key[:80], e.self_device_time_total / 1e6,
                         e.count) for e in kernels[:5]],
        "rows": {"timed": row_timed, "profiled": row_prof},
    }
    text = json.dumps(out, indent=1)
    if args.out_json:
        with open(args.out_json, "w") as fh:
            fh.write(text)
    print(text)
    return out


if __name__ == "__main__":
    main()
