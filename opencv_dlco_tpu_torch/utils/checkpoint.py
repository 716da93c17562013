"""Mid-run solver-state checkpointing.

The full solver state (a PRState or PJState: iterates, dual averages, the
counter) and the state of the run's ``torch.Generator`` snapshot into the
run's artifact file (or a sweep's sidecar) every log period, so an
interrupted run resumes from the last validation point and draws the same
samples it would have drawn. The JAX package stores a
PRNG key in the same place (``solver_state/prng_key``); the port stores the
generator's byte state as ``solver_state/rng_state``.
"""

from __future__ import annotations

import errno
import time
from typing import Optional

import numpy as np
import torch

from ..data.store import ArtifactStore

_PREFIX = "solver_state"


def is_lock_error(err: OSError) -> bool:
    """True when an HDF5 open failed on file-lock contention, not on a
    damaged file."""
    if isinstance(err, BlockingIOError):
        return True
    msg = str(err).lower()
    return ("unable to lock" in msg
            or "file is already open" in msg
            or "resource temporarily unavailable" in msg
            or getattr(err, "errno", None) == errno.EAGAIN)


def open_lock_retry(path: str, mode: str,
                    timeout_s: float = 120.0) -> ArtifactStore:
    """ArtifactStore open that retries ONLY on HDF5 lock contention.

    A locked file means "retry shortly", not "corrupt"; any other OSError
    (truncated file, bad header) surfaces immediately."""
    deadline = time.time() + timeout_s
    while True:
        try:
            return ArtifactStore(path, mode)
        except OSError as err:
            if not is_lock_error(err) or time.time() > deadline:
                raise
            time.sleep(0.2)


class RunInterrupted(RuntimeError):
    """Raised by the _stop_after_logs test hooks right after a snapshot —
    simulates a mid-run kill at a known point for resume tests."""


def save_solver_state(store: ArtifactStore, state, gen: torch.Generator,
                      extra: Optional[dict] = None,
                      compression: int = 4) -> None:
    """Snapshot a NamedTuple solver state (tensors or ints) + generator."""
    for name, leaf in state._asdict().items():
        arr = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) \
            else np.asarray(leaf, np.int64)
        store.write(f"{_PREFIX}/{name}", arr, compression=compression)
    store.write(f"{_PREFIX}/rng_state", gen.get_state().numpy(),
                compression=0)
    store.set_meta(f"{_PREFIX}_meta", {
        "fields": list(state._asdict().keys()),
        "type": type(state).__name__,
        **(extra or {}),
    })


def load_solver_state(store: ArtifactStore, state_cls, device="cuda"):
    """Restore (state, generator) saved by save_solver_state; None if absent.

    Arrays come back as tensors on ``device``, 0-d leaves as Python ints."""
    meta = store.get_meta(f"{_PREFIX}_meta")
    if not meta or not store.exists(f"{_PREFIX}/rng_state"):
        return None
    fields = {}
    for name in meta["fields"]:
        arr = store.read(f"{_PREFIX}/{name}")
        fields[name] = (int(arr) if arr.ndim == 0
                        else torch.from_numpy(arr).to(device))
    gen = torch.Generator()
    gen.set_state(torch.from_numpy(store.read(f"{_PREFIX}/rng_state")))
    return state_cls(**fields), gen
