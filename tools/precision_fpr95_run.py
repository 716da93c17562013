"""Run the bench's ``precision`` suite through its command and write its
record with the card it ran on.

    python tools/precision_fpr95_run.py --out-json PRECISION_FPR95_torch.json

The command is ``opencv_dlco_tpu_torch.cli.main(["bench", "--suite",
"precision", "--out", <details>])``: ``bench_precision_fpr95`` at its
defaults (50,000 hard synthetic pairs, the 40,960-filter bank, 512-pair
blocks, the f32 route against the bf16 route, kernel A on the card). The
suite's keys are written under ``precision_fpr95`` beside the command,
the card's nvidia-smi line (name and power limit), the torch and CUDA
versions and the launches of kernel A during the command.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from opencv_dlco_tpu_torch import bench, cli                   # noqa: E402
from opencv_dlco_tpu_torch.ops.pair_distance_fused import (  # noqa: E402
    ring_distances_fused)

from e2e_memory_run import card_line                          # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-json", required=True)
    ap.add_argument("--details", default=None,
                    help="the bench's details file (default: beside "
                         "--out-json, with .details.json)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("precision_fpr95_run: no CUDA device")
    details = args.details or os.path.splitext(args.out_json)[0] \
        + ".details.json"
    if os.path.exists(details):
        os.remove(details)            # the suite merges into a present file
    argv_bench = ["bench", "--suite", "precision", "--out", details]
    ring_distances_fused.launches = 0
    cli.main(argv_bench)
    with open(details) as fh:
        got = json.load(fh)
    rec = {"command": "python -m opencv_dlco_tpu_torch.cli "
                      + " ".join(argv_bench[:3]),
           "card": card_line(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "kernel_a_launches": ring_distances_fused.launches,
           "total_bench_time": got["total_bench_time"],
           "precision_fpr95": got["precision_fpr95"]}
    with open(args.out_json, "w") as fh:
        json.dump(rec, fh, indent=1, sort_keys=True)
    print("precision_fpr95_run:", json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
