"""Timing and device-trace instrumentation.

Port of ``opencv_dlco_tpu/utils/profiling.py``. The reference wraps
train/validate segments in getTickCount pairs and prints Ttime/Vtime per
log line (src/pr-learn.cpp:301-372); MetricLogger carries those. This
module adds the framework-level tools: a segment timer that waits for the
device before reading the clock (PyTorch returns before a CUDA kernel
ends) and an opt-in ``torch.profiler`` trace context.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class StageTimer:
    """Accumulates wall time per named segment; device-synchronising."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, sync_on=None):
        """Time the block; with ``sync_on`` (tensors, or a structure of
        them), wait for the CUDA devices they live on before reading the
        clock."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                from ..bench import _fetch

                _fetch(sync_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name}: total {tot:.4f}s  n={n}  "
                         f"avg {tot / max(n, 1):.4f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """torch.profiler trace of the CPU and CUDA activity in the block,
    written to ``log_dir`` as a Chrome trace; a no-op unless a directory is
    given or DLCO_TRACE_DIR is set."""
    log_dir = log_dir or os.environ.get("DLCO_TRACE_DIR")
    if not log_dir:
        yield None
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir
