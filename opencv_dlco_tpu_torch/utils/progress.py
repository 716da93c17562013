"""Terminal progress reporting (reference: src/misc.cpp:45-76).

Same 0..40-tick visual contract as the reference's TermProgress so logs stay
human-comparable, but implemented as a small stateful object instead of the
C-style (value, last_tick) protocol.
"""

from __future__ import annotations

import sys
import time


class TermProgress:
    """40-tick progress bar: ``0...10...20...30...40 - done.``"""

    def __init__(self, stream=None):
        self._last = -1
        self._stream = stream if stream is not None else sys.stdout
        self._t0 = time.perf_counter()

    def update(self, frac: float) -> None:
        tick = int(frac * 40.0)
        tick = max(0, min(40, tick))
        if tick < self._last and self._last >= 39:
            self._last = -1
        if tick <= self._last:
            return
        while tick > self._last:
            self._last += 1
            if self._last % 4 == 0:
                self._stream.write(f"{(self._last // 4) * 10}")
            else:
                self._stream.write(".")
        if tick == 40:
            dt = time.perf_counter() - self._t0
            self._stream.write(f" - done. ({dt:.2f}s)\n")
        self._stream.flush()

    def done(self) -> None:
        self.update(1.0)
