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
import os
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


class ShardedSweepCheckpoint:
    """Per-process sharded sweep checkpoints — no primary-writer funnel.

    A sweep's stacked solver state is S-leading per field (the
    reference-scale PJ grid is 45 x 544 x 544 over four fields, ~200 MB a
    snapshot); funnelling it through rank 0 every log period would
    serialise checkpoint IO on one process while the others idle. Here
    every process writes its OWN contiguous combo-range shard of each
    S-leading field into its OWN artifact (one writer per file),
    double-buffered into two slots so a crash mid-wave never destroys the
    last complete wave:

        {base}-p{p}of{n}.h5 : slot{0,1}/<field>, per-slot wave marker

    The loader assembles the newest wave present in EVERY process file.
    Lockstep sweeps keep processes within one wave of each other, so the
    previous wave always survives in the other slot; files that disagree
    on the signature or share no common wave resume from nothing — the
    reference's stage-level restart (workspace/04-prlearn.sh:17-22).

    Fields whose leading axis is not the sweep axis (the shared counter
    ``t``, the generator state ``rng_state``) are written whole by every
    process; the loader reads them from process 0's file.
    """

    def __init__(self, base_path: str, writer_id: int, n_writers: int,
                 n_sweep: int):
        from ..data.shard_store import shard_rows

        self.base = base_path
        self.writer_id = int(writer_id)
        self.n_writers = int(n_writers)
        self.n_sweep = int(n_sweep)
        self.lo, self.hi = shard_rows(n_sweep, 1, writer_id, n_writers)

    def path(self, p: int) -> str:
        return f"{self.base}-p{p}of{self.n_writers}.h5"

    def _shardable(self, arr: np.ndarray) -> bool:
        return arr.ndim >= 1 and arr.shape[0] == self.n_sweep

    def save(self, state, gen: torch.Generator, arrays: dict,
             signature: dict, completed_logs: int) -> None:
        """Snapshot this process's combo shard for wave ``completed_logs``."""
        slot = completed_logs % 2
        leaves = {name: _host(leaf) for name, leaf in
                  {**state._asdict(), **arrays}.items()}
        # the generator state is never sweep-stacked: excluded by name
        sharded = [n for n, v in leaves.items() if self._shardable(v)]
        leaves["rng_state"] = gen.get_state().numpy()
        # a peer's load() read-opens every writer's file, this one too
        with open_lock_retry(self.path(self.writer_id), "a") as st:
            for name, arr in leaves.items():
                if name in sharded:
                    arr = arr[self.lo:self.hi]
                st.write(f"slot{slot}/{name}", arr, compression=0)
            st.set_meta(f"slot{slot}", {"completed_logs": completed_logs})
            st.set_meta("signature", signature)
            st.set_meta("state_fields", list(state._asdict().keys()))
            st.set_meta("array_names", list(arrays.keys()))
            st.set_meta("sharded_names", sharded)

    def load(self, state_cls, signature: dict, device="cuda"):
        """Assemble (state, generator, arrays, completed_logs) from the
        newest wave all processes agree on; None if absent/incompatible.

        A shard file that vanishes between the existence scan and its
        open means a faster peer already finished the sweep and ran
        cleanup(): resume from scratch (deterministic replay converges to
        the same final artifacts)."""
        try:
            return self._load(state_cls, signature, device)
        except FileNotFoundError:
            return None

    def _load(self, state_cls, signature, device):
        from ..data.shard_store import shard_rows

        per_proc = []
        for p in range(self.n_writers):
            path = self.path(p)
            if not os.path.exists(path):
                return None
            with open_lock_retry(path, "r") as st:
                if st.get_meta("signature") != signature:
                    return None
                waves = {}
                for slot in (0, 1):
                    meta = st.get_meta(f"slot{slot}")
                    if meta:
                        waves[int(meta["completed_logs"])] = slot
                per_proc.append((waves, st.get_meta("state_fields"),
                                 st.get_meta("array_names"),
                                 set(st.get_meta("sharded_names") or [])))
        common = set(per_proc[0][0])
        for rec in per_proc[1:]:
            common &= set(rec[0])
        if not common:
            return None
        wave = max(common)
        state_fields, array_names, sharded = per_proc[0][1:]

        full, whole = {}, {}
        for p in range(self.n_writers):
            lo, hi = shard_rows(self.n_sweep, 1, p, self.n_writers)
            slot = per_proc[p][0][wave]
            with open_lock_retry(self.path(p), "r") as st:
                for name in state_fields + array_names + ["rng_state"]:
                    if name in sharded:
                        arr = st.read(f"slot{slot}/{name}")
                        buf = full.setdefault(
                            name, np.zeros((self.n_sweep,) + arr.shape[1:],
                                           arr.dtype))
                        buf[lo:hi] = arr
                    elif p == 0:
                        whole[name] = st.read(f"slot{slot}/{name}")
        merged = {**whole, **full}
        state = state_cls(**{
            k: int(merged[k]) if merged[k].ndim == 0
            else torch.from_numpy(merged[k]).to(device)
            for k in state_fields})
        gen = torch.Generator()
        gen.set_state(torch.from_numpy(merged["rng_state"]))
        arrays = {k: merged[k] for k in array_names}
        return state, gen, arrays, wave

    def cleanup(self) -> None:
        """Remove this process's own shard file (call on every process)."""
        from ..data.store import remove_artifact

        path = self.path(self.writer_id)
        if os.path.lexists(path):
            remove_artifact(path)


def _host(leaf) -> np.ndarray:
    """A state leaf or array as numpy (ints as 0-d int64)."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    arr = np.asarray(leaf)
    return arr.astype(np.int64) if arr.ndim == 0 else arr
