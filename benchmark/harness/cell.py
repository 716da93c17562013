"""One run of one cell: set-up, the window, the check, the result line.

``run_cell`` is the whole run but the look for a card and the final
print, so the tests can drive it on the CPU at a small size.
"""

from __future__ import annotations

import math
import tempfile
import time
from typing import Dict, Optional

import torch

from . import env, spec
from .trace import Recorder, reduce_trace


class Context:
    """What an entry is given: the cell's files, the seed, the window's
    length, the recorder, a scratch directory (removed when the run
    ends), the checkout's cache directory (kept from run to run), and
    the set-up clock."""

    def __init__(self, cell: dict, seed: int, seconds: float, traced: bool,
                 device, workdir: str, t_start: float):
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.workdir = workdir
        self.cache_dir = env.CACHE_DIR
        self.rec = Recorder(traced, self.device)
        self.t_start = t_start
        self.setup_s: Optional[float] = None
        self.memory_peak_bytes = 0

    def setup_done(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_s = time.perf_counter() - self.t_start

    def window_done(self, win) -> None:
        """Read the device's peak right after the window, before the
        check allocates anything."""
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))


class RunRecord:
    """What a per-layer reader reads: the spans, the window, the trace
    summary, the work counted from shapes and the peak the
    configuration's products are held to."""

    def __init__(self, ctx: Context, out: dict, trace, peak_flops: float,
                 hbm: float):
        self.spans = ctx.rec.spans
        self.window = (out["window"].t0, out["window"].t1)
        self.window_s = out["window"].seconds
        self.trace = trace
        self.work = out["work"]
        self.peak_flops = peak_flops
        self.hbm_bytes_per_s = hbm

    def spans_in_window(self, name: str):
        lo, hi = self.window
        return [(s, e) for s, e in self.spans.get(name, ())
                if s >= lo and e <= hi]


def _limits_ok(numbers: Dict[str, float], limits: dict):
    checks = {}
    for name, lim in limits["compare"].items():
        v = numbers[name]
        checks[name] = {"value": v, "limit": lim["limit"],
                        "ok": bool(math.isfinite(v) and v <= lim["limit"])}
    return checks


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device="cuda", t_start: Optional[float] = None,
             bench: Optional[dict] = None, cell: Optional[dict] = None,
             control: bool = False):
    """Run a cell: (its result line as a dict, ``checks`` last; what goes
    on the earlier lines: counts, window, peak memory, every number the
    check computed and, where the entry gives them, its per-entry
    readings; with ``control``, also the control's numbers)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec.benchmark_json() if bench is None else bench
    cell = spec.cell(name, bench) if cell is None else cell
    entry = spec.load_module("entries", cell["traffic"]["entry"])
    peaks = spec.peaks()
    peak = peaks["flops"][cell["config"]["peak_of"][entry.PEAK_OF]]
    with tempfile.TemporaryDirectory(prefix="dlco_bench_") as work:
        ctx = Context(cell, seed, seconds, traced, device, work, t_start)
        out = entry.run(ctx)
    trace = None
    if traced and out["window"].prof is not None:
        trace = reduce_trace(out["window"].prof)
    t_judge = time.perf_counter()
    judged = out["judge"](control)
    judge_s = time.perf_counter() - t_judge
    numbers = judged["program"]
    checks = _limits_ok(numbers, cell["limits"])

    metrics = {}
    if not traced:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        record = RunRecord(ctx, out, trace, peak, peaks["hbm_bytes_per_s"])
        for m in cell["per_layer"]:
            v = spec.load_module("metrics", m["name"]).read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = torch.device(device)
    result = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": out["attempted"], "failed": out["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell["workload"]["chips"],
            "memory_peak_bytes": ctx.memory_peak_bytes},
    }
    if trace is not None:
        result["device"]["busy_s"] = trace.busy_s()
        result["device"]["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    info = dict(out["info"], setup_s=ctx.setup_s,
                window_s=out["window"].seconds,
                memory_peak_bytes=ctx.memory_peak_bytes, judge_s=judge_s,
                numbers=numbers)
    if control:
        info["control"] = judged["control"]
    if "entries" in judged:
        info["entries"] = judged["entries"]
    return result, info
