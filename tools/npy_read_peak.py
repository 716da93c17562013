"""Peak host memory and seconds of prstats' whole read of a stage-3
matrix, through the .npy container of each of two trees.

    python tools/npy_read_peak.py -a <workspace>/distances/synlib-dist.h5 \
        --trees <parent tree> <tree> --order 0 1 1 0 --out-json <path>

Each run is a fresh process with ``PYTHONPATH=<tree>``, so the
``opencv_dlco_tpu_torch`` of that tree is imported; it does what
``Workspace.prstats`` does for one dataset:
``torch.from_numpy(ArtifactStore(a, "r").read("Distance")).to(device)``
(the card when there is one). It reports the seconds of the read and of
the upload, and its peak resident memory above what it held before the
read (``ru_maxrss`` of ``getrusage``, a high-water mark), with
``/proc/self/status``'s ``VmHWM`` and ``VmRSS`` after the upload.
``--order`` lists the trees by position, so the trees alternate in one
call.
"""

import argparse
import json
import os
import resource
import subprocess
import sys
import time


def one(artifact: str) -> dict:
    import torch
    from opencv_dlco_tpu_torch.data import npy_container
    from opencv_dlco_tpu_torch.data.store import ArtifactStore

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    t0 = time.perf_counter()
    with ArtifactStore(artifact, "r") as st:
        arr = st.read("Distance")
    t1 = time.perf_counter()
    tensor = torch.from_numpy(arr).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    status = {}
    with open("/proc/self/status") as fh:
        for line in fh:
            key, _, rest = line.partition(":")
            if key in ("VmHWM", "VmRSS"):
                status[key] = int(rest.split()[0]) * 1024
    return {"container": npy_container.__file__, "device": str(dev),
            "vm_hwm_bytes": status.get("VmHWM"),
            "vm_rss_after_bytes": status.get("VmRSS"),
            "bytes": int(arr.nbytes), "shape": list(tensor.shape),
            "read_seconds": t1 - t0, "upload_seconds": t2 - t1,
            "peak_above_start_bytes": peak - base,
            "peak_over_matrix": (peak - base) / arr.nbytes}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-a", "--artifact", required=True)
    ap.add_argument("--trees", nargs="+")
    ap.add_argument("--order", nargs="+", type=int)
    ap.add_argument("--out-json")
    ap.add_argument("--one", action="store_true",
                    help="run once in this process and print the JSON")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.artifact)), flush=True)
        return
    runs = []
    for i in args.order or range(len(args.trees)):
        tree = os.path.abspath(args.trees[i])
        env = dict(os.environ, PYTHONPATH=tree)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", "-a",
             args.artifact], env=env, check=True,
            capture_output=True, text=True).stdout
        rec = dict(json.loads(out.strip().splitlines()[-1]), tree=tree)
        print("npy_read_peak:", json.dumps(rec), flush=True)
        runs.append(rec)
    if args.out_json:
        with open(args.out_json, "w") as fh:
            json.dump({"artifact": args.artifact, "runs": runs}, fh,
                      indent=1)


if __name__ == "__main__":
    main()
