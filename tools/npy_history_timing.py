"""Time a finished ``e2e`` workspace's PR histories through the .npy
artifact container, and the PR geometry lookups that prstats makes.

    PYTHONPATH=<tree> python tools/npy_history_timing.py -w <workspace> \
        --out-json <path> [--geometry]

Appends: every PR history of the workspace (the ``w`` dataset of each
``pr-learn/*.h5`` artifact) is replayed, row by row and with the same
rows, into a fresh artifact through ``ArtifactStore.append_row`` (the
sweep's call), in the .npy container that a host without h5py uses. Then
one history of ``--long-rows`` rows: a combo whose iterate passes the
640-D cap in every log period of a 50M-sample run (508 periods of 48
steps of 2,048). The container timed is that of the
``opencv_dlco_tpu_torch`` first on ``sys.path``, so PYTHONPATH chooses
the tree; the script adds no path of its own.

Geometry (``--geometry``, a tree with ``models.select.pr_geometry``): each
saved row's (n_pr, dim, nz_dim) on the workspace's bank, once for each of
the three datasets as prstats asks for them, timed through
``selected_pr_geometry`` (which looks the bank's row groups up by hashing
the whole bank on every call) and through one ``pr_geometry(bank)`` a
history, in the order per call, per history, per history, per call.

Host seconds from ``time.perf_counter``; the JSON also names the
container's file and the card from ``nvidia-smi``.
"""

import argparse
import glob
import json
import os
import shutil
import subprocess
import time

import numpy as np

import opencv_dlco_tpu_torch.data.npy_container as npy_container
import opencv_dlco_tpu_torch.data.store as store
from opencv_dlco_tpu_torch.data.store import ArtifactStore

N_DATASETS = 3          # prstats evaluates every history on each dataset


def histories(ws: str):
    """{artifact name: w history} of every PR artifact of the workspace."""
    out = {}
    for path in sorted(glob.glob(os.path.join(ws, "pr-learn", "*.h5"))):
        with ArtifactStore(path, "r") as st:
            if st.exists("w"):
                out[os.path.basename(path)] = st.read("w")
    return out


def replay(rows_by_name, scratch: str) -> float:
    """Seconds to append every history's rows, one at a time, into fresh
    .npy artifacts under ``scratch``."""
    shutil.rmtree(scratch, ignore_errors=True)
    t0 = time.perf_counter()
    for name, rows in rows_by_name.items():
        with ArtifactStore(os.path.join(scratch, name), "w") as st:
            for row in rows:
                st.append_row("w", row)
    seconds = time.perf_counter() - t0
    for name, rows in rows_by_name.items():
        with ArtifactStore(os.path.join(scratch, name), "r") as st:
            if not np.array_equal(st.read("w"), rows):
                raise AssertionError(f"replayed history {name} differs")
    shutil.rmtree(scratch)
    return seconds


def geometry_seconds(params, hists):
    from opencv_dlco_tpu_torch.models.select import (
        pr_geometry, selected_pr_geometry)

    def per_call():
        return [[selected_pr_geometry(params, r) for r in h]
                for _ in range(N_DATASETS) for h in hists]

    def per_history():
        out = []
        for _ in range(N_DATASETS):
            for h in hists:
                geometry = pr_geometry(params)
                out.append([geometry(r) for r in h])
        return out

    seconds = {"per_call": [], "per_history": []}
    results = []
    for mode in ("per_call", "per_history", "per_history", "per_call"):
        fn = per_call if mode == "per_call" else per_history
        t0 = time.perf_counter()
        results.append(fn())
        seconds[mode].append(time.perf_counter() - t0)
    if any(r != results[0] for r in results):
        raise AssertionError("the two geometry routes disagree")
    return {"calls": sum(len(h) for h in hists) * N_DATASETS,
            "bank_lookups_per_history": len(hists) * N_DATASETS,
            "seconds": seconds}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-w", "--workspace", required=True)
    ap.add_argument("--out-json", required=True)
    ap.add_argument("--long-rows", type=int, default=508)
    ap.add_argument("--width", type=int, default=5120)
    ap.add_argument("--geometry", action="store_true")
    args = ap.parse_args()

    store.h5py = None                       # the .npy container
    hists = histories(args.workspace)
    counts = [h.shape[0] for h in hists.values()]
    row_bytes = args.width * 4
    long_rows = np.random.default_rng(0).standard_normal(
        (args.long_rows, args.width)).astype(np.float32)
    scratch = os.path.join(args.workspace, "history_timing")
    out = {
        "container": os.path.abspath(npy_container.__file__),
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(),
        "histories": len(counts),
        "rows": int(sum(counts)),
        "max_rows": int(max(counts)),
        "row_bytes": row_bytes,
        # what a container that rewrites the history on each append writes
        "rewrite_bytes": int(sum(n * (n + 1) // 2 for n in counts))
        * row_bytes,
        "replay_seconds": replay(hists, scratch),
        "long_rows": args.long_rows,
        "long_rewrite_bytes": args.long_rows * (args.long_rows + 1) // 2
        * row_bytes,
        "long_seconds": replay({"long-pr.h5": long_rows}, scratch),
    }
    if args.geometry:
        with ArtifactStore(os.path.join(args.workspace, "filters.h5"),
                           "r") as st:
            params = st.read("PRParams")
        out["geometry"] = geometry_seconds(params, list(hists.values()))
    print(json.dumps(out), flush=True)
    with open(args.out_json, "w") as fh:
        json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
