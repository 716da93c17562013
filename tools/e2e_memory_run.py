"""Run the port's ``e2e`` command in-process and record, stage by stage,
its seconds, peak host memory and peak device memory, and the kernel
launches of the whole run.

    python tools/e2e_memory_run.py -w <fresh workspace> \
        --out-json E2E_M50_torch.json --mem-json <path> \
        [--n-pairs N] [--pj-iters N] [--matmul-precision default]

The command is ``opencv_dlco_tpu_torch.cli.main(["e2e", "-w", <ws>,
"--out-json", <out>, ...])``: the ``e2e`` command at its defaults (3 x
500,000 pairs, 50,000 PJ iterations) unless ``--n-pairs`` / ``--pj-iters``
are given, which pass through to it. The workspace must hold no stage-3
artifact: compdist reuses a complete one whatever precision wrote it.

``--matmul-precision default`` runs stage 3 on the bf16 route (kernel A,
and stage 7's products on bf16 operands): while the run lasts,
``stages.Workspace`` is a subclass whose ``desc_cfg`` defaults to
``DescriptorConfig(matmul_precision="default")`` (``run_reference_scale``
imports it at call time). Both JSONs then name the precision and the
route stage 3 took (``stage3_route``, from the routes of the calls
``_dist_rows`` made to ``stages.stage3_distances``: kernel A's bf16 mode,
"kernel_A", its f32 mode, "kernel_A_f32", or the f32 ``ring_distances``,
"f32"; on the card kernel A's launch counts, ``A`` and ``A_f32``, say the
same).

Nothing else in the package is switched: the stage functions
``run_full`` calls are wrapped here for the duration of the run, and the
outermost call of each records

- ``seconds``: host clock from entry to exit (the card synchronised at
  both ends);
- ``device_peak_bytes`` / ``device_reserved_peak_bytes``:
  ``torch.cuda.max_memory_allocated`` / ``max_memory_reserved`` after
  ``reset_peak_memory_stats`` at entry;
- ``host_rss_peak_bytes``: the largest ``VmRSS`` of ``/proc/self/status``
  seen by a thread that reads it every ``--sample-s`` seconds (it counts
  the pages of the mapped CUDA libraries and, while they are mapped, of
  memory-mapped artifacts, beside the process's own arrays).

Kernel launches are each wrapper's count (A-H), set to 0 before the run
and read after it. The JSON also carries the card's nvidia-smi line, the
workspace's disk use and the host's memory and disk before and after.
"""

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import resource
import shutil
import subprocess
import sys
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from opencv_dlco_tpu_torch import cli                        # noqa: E402
from opencv_dlco_tpu_torch.ops import fused_rda, hinge, knn_fused  # noqa
from opencv_dlco_tpu_torch.ops.pair_distance_fused import (  # noqa: E402
    ring_distances_fused)
from opencv_dlco_tpu_torch.parallel import sweep             # noqa: E402
from opencv_dlco_tpu_torch.pipeline import e2e, stages      # noqa: E402
from opencv_dlco_tpu_torch.utils.configs import (            # noqa: E402
    DescriptorConfig)

WRAPPERS = {"A": ring_distances_fused,
            "B": fused_rda.fused_block_train_wide,
            "C": fused_rda.fused_block_train,
            "D": fused_rda.fused_block_grad,
            "E": hinge.hinge_sum_blockwise,
            "F": knn_fused.knn2_fused,
            "G": knn_fused.knn2_fused_batched,
            "H": knn_fused.knnk_fused}


def rss_bytes() -> int:
    """VmRSS of this process in bytes."""
    with open("/proc/self/status") as fh:
        for line in fh:
            key, _, rest = line.partition(":")
            if key == "VmRSS":
                return int(rest.split()[0]) * 1024
    return 0


class Sampler(threading.Thread):
    """Keeps the largest VmRSS seen since the last ``window()``."""

    def __init__(self, period: float):
        super().__init__(daemon=True)
        self.period = period
        self.peak = 0
        self._halt = threading.Event()

    def window(self):
        self.peak = rss_bytes()

    def run(self):
        while not self._halt.wait(self.period):
            self.peak = max(self.peak, rss_bytes())

    def stop(self):
        self._halt.set()
        self.join()


def host_facts(path: str) -> dict:
    du = shutil.disk_usage(path)
    with open("/proc/meminfo") as fh:
        mem = {k: int(v.split()[0]) * 1024 for k, _, v in
               (line.partition(":") for line in fh)
               if k in ("MemTotal", "MemAvailable")}
    return {"disk_total_bytes": du.total, "disk_free_bytes": du.free, **mem}


def dir_bytes(root: str) -> dict:
    """Apparent bytes of each top-level entry of the workspace."""
    out = {}
    for top in sorted(os.listdir(root)):
        total = 0
        for dirpath, _, files in os.walk(os.path.join(root, top)):
            total += sum(os.path.getsize(os.path.join(dirpath, f))
                         for f in files)
        if os.path.isfile(os.path.join(root, top)):
            total = os.path.getsize(os.path.join(root, top))
        out[top] = total
    return out


def unproj_ds(ws, path: str) -> str:
    """The dataset of ``distances/{ds}-{pr}#{row}-unproj.h5``: the longest
    dataset name of the workspace that the file name starts with."""
    base = os.path.basename(path)
    names = [n[:-len(".h5")] for n in os.listdir(ws.path("dataset", ""))
             if n.endswith(".h5") and base.startswith(n[:-len(".h5")] + "-")]
    return max(names, key=len) if names else base


def install(sampler: Sampler, records: dict):
    """Wrap the stage functions run_full and run_reference_scale call;
    returns a function that restores them."""
    active = []
    dev = torch.device("cuda")

    def wrap(owner, attr, key_of):
        inner = getattr(owner, attr)

        @functools.wraps(inner)
        def timed(*a, **kw):
            if active:                       # a stage inside a stage
                return inner(*a, **kw)
            key = key_of(*a, **kw)
            active.append(key)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            sampler.window()
            t0 = time.perf_counter()
            try:
                return inner(*a, **kw)
            finally:
                torch.cuda.synchronize(dev)
                secs = time.perf_counter() - t0
                rec = records.setdefault(key, {"seconds": 0.0,
                                               "device_peak_bytes": 0,
                                               "device_reserved_peak_bytes": 0,
                                               "host_rss_peak_bytes": 0})
                rec["seconds"] += secs
                for k, v in (
                        ("device_peak_bytes",
                         torch.cuda.max_memory_allocated(dev)),
                        ("device_reserved_peak_bytes",
                         torch.cuda.max_memory_reserved(dev)),
                        ("host_rss_peak_bytes",
                         max(sampler.peak, rss_bytes()))):
                    rec[k] = max(rec[k], int(v))
                active.pop()
        setattr(owner, attr, timed)
        return owner, attr, inner

    ws_cls = stages.Workspace
    saved = [
        wrap(e2e, "generate_synthetic_dataset",
             lambda ws, name, *a, **kw: f"01_generate[{name}]"),
        wrap(ws_cls, "genpr", lambda self: "02_genpr"),
        wrap(ws_cls, "compdist",
             lambda self, ds, *a, **kw: f"03_compdist[{ds}]"),
        wrap(sweep, "run_pr_sweep",
             lambda ws, ds, *a, **kw: f"04_prsweep[{ds}]"),
        wrap(ws_cls, "prstats", lambda self, *a, **kw: "05_prstats"),
        wrap(ws_cls, "compunproj",
             lambda self, ds, *a, **kw: f"07_compunproj[{ds}]"),
        wrap(sweep, "run_pj_sweep",
             lambda ws, path, *a, **kw: f"08_pjsweep[{unproj_ds(ws, path)}]"),
        wrap(ws_cls, "pjstats", lambda self, *a, **kw: "09_pjstats"),
        wrap(ws_cls, "export",
             lambda self, pr_ref, pj_path, out_name:
             f"11_export[{out_name[len('vgg_generated_'):-len('.i')]}]"),
    ]

    def restore():
        for owner, attr, inner in saved:
            setattr(owner, attr, inner)
    return restore


@contextlib.contextmanager
def stage3_precision(precision: str):
    """While the block runs, ``stages.Workspace`` is a subclass whose
    ``desc_cfg`` defaults to ``DescriptorConfig(matmul_precision=
    precision)``; "highest" leaves it as it is."""
    base = stages.Workspace
    if precision != "highest":
        opted = dataclasses.make_dataclass(
            f"Workspace_{precision}",
            [("desc_cfg", DescriptorConfig,
              dataclasses.field(default=DescriptorConfig(
                  matmul_precision=precision)))],
            bases=(base,))
        stages.Workspace = opted
    try:
        yield
    finally:
        stages.Workspace = base


@contextlib.contextmanager
def stage3_route():
    """Counts the calls ``Workspace._dist_rows`` makes to
    ``stages.stage3_distances`` on each route while the block runs; yields
    the counts: "kernel_A" (kernel A's bf16 mode), "kernel_A_f32" (its f32
    mode) and "f32"."""
    calls = {"kernel_A": 0, "kernel_A_f32": 0, "f32": 0}
    inner = stages.stage3_distances

    @functools.wraps(inner)
    def counted(filters, route, *a, **kw):
        calls[route] += 1
        return inner(filters, route, *a, **kw)

    stages.stage3_distances = counted
    try:
        yield calls
    finally:
        stages.stage3_distances = inner


def route_name(calls: dict) -> str:
    """The one route stage 3 took: "kernel_A", "kernel_A_f32" or "f32";
    raises if more than one or none ran."""
    taken = [name for name, n in calls.items() if n]
    if len(taken) != 1:
        raise RuntimeError(f"stage 3 took {taken or 'no'} route: {calls}")
    return taken[0]


def stage3_artifacts(root: str) -> list:
    """The stage-3 outputs a workspace already holds."""
    d = os.path.join(root, "distances")
    if not os.path.isdir(d):
        return []
    return sorted(n for n in os.listdir(d)
                  if n.endswith(("-dist.h5", "-dist.shards")))


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
    ap.add_argument("--out-json", required=True)
    ap.add_argument("--mem-json", required=True)
    ap.add_argument("--sample-s", type=float, default=0.2)
    ap.add_argument("--n-pairs", type=int, default=None,
                    help="passed to the e2e command (its default: 500,000)")
    ap.add_argument("--pj-iters", type=int, default=None,
                    help="passed to the e2e command (its default: 50,000)")
    ap.add_argument("--matmul-precision", choices=("highest", "default"),
                    default="highest",
                    help="stage 3's DescriptorConfig.matmul_precision for "
                         "the run: default takes kernel A")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("e2e_memory_run: no CUDA device")
    used = stage3_artifacts(args.workspace)
    if used:
        raise SystemExit(f"e2e_memory_run: {args.workspace} already holds "
                         f"stage-3 output {used}; compdist would reuse it "
                         f"whatever its precision: use a fresh workspace")
    os.makedirs(args.workspace, exist_ok=True)
    argv_e2e = ["e2e", "-w", args.workspace, "--out-json", args.out_json]
    for flag, val in (("--n-pairs", args.n_pairs),
                      ("--pj-iters", args.pj_iters)):
        if val is not None:
            argv_e2e += [flag, str(val)]
    facts = {"card": card_line(), "argv": argv_e2e,
             "matmul_precision": args.matmul_precision,
             "host_before": host_facts(args.workspace)}
    print("e2e_memory_run:", json.dumps(facts), flush=True)

    records = {}
    sampler = Sampler(args.sample_s)
    sampler.start()
    restore = install(sampler, records)
    for w in WRAPPERS.values():
        w.launches = 0
    ring_distances_fused.launches_f32 = 0
    t0 = time.perf_counter()
    try:
        with stage3_precision(args.matmul_precision), \
                stage3_route() as calls:
            cli.main(facts["argv"])
    finally:
        restore()
        sampler.stop()
    facts["wall_seconds"] = time.perf_counter() - t0
    facts["stage3_calls"] = calls
    facts["stage3_route"] = route_name(calls)
    facts["launches"] = {k: w.launches for k, w in WRAPPERS.items()}
    facts["launches"]["A_f32"] = ring_distances_fused.launches_f32
    with open(args.out_json) as fh:
        summary = json.load(fh)
    summary.update(matmul_precision=args.matmul_precision,
                   stage3_route=facts["stage3_route"])
    with open(args.out_json, "w") as fh:
        json.dump(summary, fh, indent=1, sort_keys=True)
    facts["stages"] = records
    facts["ru_maxrss_bytes"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    facts["device_peak_bytes"] = max(
        r["device_peak_bytes"] for r in records.values())
    facts["host_after"] = host_facts(args.workspace)
    facts["workspace_bytes"] = dir_bytes(args.workspace)
    with open(args.mem_json, "w") as fh:
        json.dump(facts, fh, indent=1, sort_keys=True)
    print("e2e_memory_run launches:", json.dumps(facts["launches"]),
          flush=True)
    for key, rec in records.items():
        print(f"  {key:24s} {rec['seconds']:10.3f} s  host rss "
              f"{rec['host_rss_peak_bytes'] / 1e9:7.2f} GB  device "
              f"{rec['device_peak_bytes'] / 1e9:7.2f} GB", flush=True)


if __name__ == "__main__":
    main()
