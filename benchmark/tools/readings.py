"""The readings a cell's limits are set from, on the card at full size.

    python3 benchmark/tools/readings.py --cell m50_f32.pjgrid \
        --seeds 11,12,13 [--faults unchanged,half_batch] \
        [--fault-seeds 21,22,23] --out readings.json

For every seed: the program's numbers against the plain reference (the
lower readings) and the control's, the reference in TF32 in the
program's place (the upper readings). With ``--faults``, the program's
numbers with each planted fault or lower-precision path (tools/faults.py:
``FAULTS`` and ``PRECISION``) on ``--fault-seeds``.
The window is cut to what the check needs: one block past set-up for
stage 3, one-step chunks for the PJ grid (its check follows the set-up's
first steps). Runs in one process; prints a line a run and a summary.
"""

import argparse
import contextlib
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import env  # noqa: E402

env.set_cache_dirs()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import spec
    from benchmark.harness.cell import run_cell
    from benchmark.tools.faults import FAULTS, PRECISION

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = spec.benchmark_json()
    cell = copy.deepcopy(spec.cell(args.cell, bench))
    if "pj" in cell["config"]:
        cell["config"]["pj"]["log_step"] = 1
    entry = cell["traffic"]["entry"]
    planted = dict(FAULTS[entry], **PRECISION.get(entry, {}))
    rows = []

    def one(seed, fault=None):
        t = time.perf_counter()
        with planted[fault]() if fault else contextlib.nullcontext():
            res, info = run_cell(args.cell, seed, 0.0, False, "cuda",
                                 bench=bench, cell=cell,
                                 control=fault is None)
        row = {"seed": seed, "fault": fault, "program": info["numbers"],
               "control": info.get("control"),
               "entries": info.get("entries"),
               "correct": res["correct"],
               "seconds": time.perf_counter() - t}
        print(json.dumps(row), flush=True)
        rows.append(row)

    print("card:", env.card_line(), flush=True)
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        one(seed)
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in [int(s) for s in args.fault_seeds.split(",") if s]:
            one(seed, fault)

    summary = {}
    sound = [r for r in rows if r["fault"] is None]
    for name in sound[0]["program"]:
        summary[name] = {
            "lower": max(r["program"][name] for r in sound),
            "upper_control": min(r["control"][name] for r in sound)}
        for fault in {r["fault"] for r in rows if r["fault"]}:
            summary[name][f"fault_{fault}"] = min(
                r["program"][name] for r in rows if r["fault"] == fault)
    print("summary:", json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"cell": args.cell, "card": env.card_line(),
                       "rows": rows, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
