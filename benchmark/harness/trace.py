"""Spans, the measured window and the reduction of the profiler's trace.

The benchmark records spans around its own calls into the program (the
program has none yet). In a run with ``--trace 1`` each span is also a
``record_function`` range, the window runs under ``torch.profiler``, and
``reduce_trace`` turns the trace into what the per-layer readers use:
the device's busy seconds, compute-kernel seconds inside given spans, the
device operations that took most time, and the idle gaps named by the
span the host was in. Times are the trace's own, in seconds.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import torch

PREFIX = "bench::"
TOP = 10


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """Host-clock spans of the benchmark's calls."""

    def __init__(self, traced: bool, device):
        self.traced = traced
        self.device = device
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """Time the block on the host clock; with ``sync`` in a traced run,
        wait for the device before the span ends, so the device work the
        block launched lies inside it."""
        rf = (torch.profiler.record_function(PREFIX + name) if self.traced
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
            if sync and self.traced:
                _sync(self.device)
        self.spans[name].append((t0, time.perf_counter()))


class Window:
    """The measured window: the device idle at both ends; under the
    profiler in a traced run."""

    def __init__(self, rec: Recorder):
        self.rec = rec
        self.prof = None
        self.t0 = self.t1 = None
        self._range = None

    def __enter__(self):
        _sync(self.rec.device)
        if self.rec.traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(self.rec.device).type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self._range = torch.profiler.record_function(PREFIX + "window")
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.rec.device)
        self.t1 = time.perf_counter()
        if self.prof is not None:
            self._range.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _union(intervals: Sequence[Tuple[float, float]]):
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_compute(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


class TraceSummary:
    """The trace of one window, in seconds on the trace's own clock."""

    def __init__(self, device_ops, spans, window):
        self.device_ops = device_ops      # [(start, end, name)]
        self.spans = spans                # name -> [(start, end)]
        self.window = window              # (start, end)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def _busy(self):
        lo, hi = self.window
        return _union([(max(s, lo), min(e, hi)) for s, e, _ in
                       self.device_ops if e > lo and s < hi])

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device, inside the
        window."""
        return sum(e - s for s, e in self._busy())

    def compute_s(self, within: Sequence[Tuple[float, float]]) -> float:
        """Seconds of compute kernels (no copies or memsets) that start
        inside one of the intervals ``within``."""
        iv = _union(within)
        total = 0.0
        for s, e, name in self.device_ops:
            if _is_compute(name) and any(a <= s < b for a, b in iv):
                total += e - s
        return total

    def top_device_ops(self, n: int = TOP):
        by = defaultdict(float)
        for s, e, name in self.device_ops:
            by[name[:120]] += e - s
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = TOP):
        """The device's idle time inside the window, summed by the
        innermost benchmark span the host was in at each gap's middle."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self._busy() for x in iv] + [hi]
        by = defaultdict(float)
        for i in range(0, len(edges), 2):
            s, e = edges[i], edges[i + 1]
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            best, width = "host", float("inf")
            for name, ivs in self.spans.items():
                if name == "window":
                    continue
                for a, b in ivs:
                    if a <= mid < b and b - a < width:
                        best, width = name, b - a
            by[best] += e - s
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def reduce_trace(prof) -> TraceSummary:
    """The profiler's events as device operations and benchmark spans.

    Reads the raw event records (``kineto_results``) rather than
    ``prof.events()``, whose per-event objects and operator tree take
    about a minute a PJ chunk to build: the reduction stays short however
    many launches a window holds."""
    from torch.autograd import DeviceType

    device_ops, spans = [], defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, end = ev.start_ns() / 1e9, ev.end_ns() / 1e9
        if name.startswith(PREFIX):
            if ev.device_type() == DeviceType.CPU:
                spans[name[len(PREFIX):]].append((start, end))
            continue
        if (ev.device_type() == DeviceType.CUDA and not name.startswith("[")
                and not ev.is_user_annotation()):
            device_ops.append((start, end, name))
    windows = spans.get("window") or [(0.0, 0.0)]
    return TraceSummary(device_ops, dict(spans), windows[0])
