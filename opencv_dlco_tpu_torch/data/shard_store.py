"""Sharded multi-writer array store: one .npy file per row chunk.

Port of ``opencv_dlco_tpu/data/shard_store.py``. The reference's artifact
files are single-writer (h5py enforces it), so a multi-process stage 3 —
each process computing a row range of the distance matrix — cannot stream
into one HDF5 file. This store keeps ArtifactStore's named-2D-array model
over a directory where every row chunk of an array is its own file:
writes to DISJOINT CHUNKS are concurrency-safe, so every process writes
its own chunk-aligned row range directly, with no primary-writer funnel.

The JAX package backs the same layout with tensorstore's zarr arrays; the
port uses plain numpy files, one format wherever it runs (the CUDA host
has no tensorstore):

    <root>/<name>/array.json     shape, dtype, chunk_rows
    <root>/<name>/<k>.npy        rows [k * chunk_rows, (k + 1) * chunk_rows)
    <root>/_meta/done-<w>.json   writer w's completion marker
    <root>/_meta/meta.json       free-form metadata

A chunk never written reads as zeros (zarr's fill value). Every file is
written to a temporary name and renamed into place, so a reader never sees
a torn chunk.

Write discipline (enforced, not advisory):
  * array creation is idempotent and race-tolerant (all processes may call
    create; a second call with another shape or dtype raises);
  * ``write_rows`` requires chunk-aligned starts and either chunk-aligned
    lengths or a write that ends at the array boundary — exactly the
    disjoint-chunk condition under which concurrent writers never touch
    the same file;
  * completion is per-writer: each process marks its own shard done and
    readers gate on all_done(n_writers).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

META = "_meta"


def _write_atomic(path: str, write) -> None:
    """write(tmp) to a name of this process, then rename over ``path``."""
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


def _dump_json(path: str, obj) -> None:
    def write(tmp):
        with open(tmp, "w") as fh:
            json.dump(obj, fh)
    _write_atomic(path, write)


class ShardedArrayStore:
    """Directory of named chunked arrays with multi-writer row writes."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, META), exist_ok=True)
        self._info: dict = {}

    # -- array lifecycle ---------------------------------------------------

    def _info_path(self, name: str) -> str:
        return os.path.join(self.root, name, "array.json")

    def create(self, name: str, shape: Tuple[int, ...], dtype,
               chunk_rows: int) -> None:
        """Idempotent, race-tolerant creation of a chunked array.

        chunk_rows is the leading-axis chunk size — the write-granularity
        contract every writer must honour. Trailing axes are unchunked."""
        info = {"shape": [int(s) for s in shape],
                "dtype": np.dtype(dtype).str,
                "chunk_rows": int(min(chunk_rows, shape[0]) or 1)}
        os.makedirs(os.path.join(self.root, name), exist_ok=True)
        if self.exists(name):
            have = self._load_info(name)
            if have != info:
                raise ValueError(f"{name}: exists as {have}, not {info}")
            return
        _dump_json(self._info_path(name), info)
        self._info[name] = info

    def _load_info(self, name: str) -> dict:
        if name not in self._info:
            with open(self._info_path(name)) as fh:
                self._info[name] = json.load(fh)
        return self._info[name]

    def exists(self, name: str) -> bool:
        return os.path.exists(self._info_path(name))

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._load_info(name)["shape"])

    def chunk_rows(self, name: str) -> int:
        return int(self._load_info(name)["chunk_rows"])

    def _chunk(self, name: str, k: int) -> str:
        return os.path.join(self.root, name, f"{k}.npy")

    # -- multi-writer IO ---------------------------------------------------

    def write_rows(self, name: str, start: int, arr: np.ndarray) -> None:
        """Write arr into rows [start, start+len) — chunk-aligned only."""
        info = self._load_info(name)
        rows, n_total = info["chunk_rows"], info["shape"][0]
        n = arr.shape[0]
        if n == 0:
            # empty shard (more writers than chunks): nothing to write and
            # a clamped start (shard_rows) may sit mid-chunk
            return
        if start % rows:
            raise ValueError(
                f"write start {start} not aligned to chunk_rows {rows}")
        if n % rows and start + n != n_total:
            raise ValueError(
                f"write length {n} not chunk-aligned (chunk_rows {rows}) "
                f"and does not end at the array boundary {n_total}")
        if start + n > n_total or tuple(arr.shape[1:]) != tuple(
                info["shape"][1:]):
            raise ValueError(f"rows {arr.shape} at {start} do not fit "
                             f"{name} {tuple(info['shape'])}")
        arr = np.ascontiguousarray(arr, dtype=np.dtype(info["dtype"]))
        for s in range(0, n, rows):
            def write(tmp, part=arr[s:s + rows]):
                with open(tmp, "wb") as fh:
                    np.save(fh, part, allow_pickle=False)
            _write_atomic(self._chunk(name, (start + s) // rows), write)

    def read(self, name: str, lo: int = 0,
             hi: Optional[int] = None) -> np.ndarray:
        info = self._load_info(name)
        rows, shape = info["chunk_rows"], info["shape"]
        hi = shape[0] if hi is None else min(hi, shape[0])
        out = np.zeros((max(hi - lo, 0),) + tuple(shape[1:]),
                       np.dtype(info["dtype"]))
        for k in range(lo // rows, -(-hi // rows)):
            path = self._chunk(name, k)
            if not os.path.exists(path):
                continue            # never written: zeros
            c0 = k * rows
            a, b = max(lo, c0), min(hi, c0 + rows)
            out[a - lo:b - lo] = np.load(path, mmap_mode="r")[a - c0:b - c0]
        return out

    # -- completion + metadata (JSON sidecars; tiny, per-writer files) ------

    def mark_done(self, writer_id: int, payload: Optional[dict] = None):
        _dump_json(os.path.join(self.root, META, f"done-{writer_id}.json"),
                   {"writer": writer_id, **(payload or {})})

    def all_done(self, n_writers: int) -> bool:
        return all(
            os.path.exists(os.path.join(self.root, META, f"done-{w}.json"))
            for w in range(n_writers))

    def set_meta(self, key: str, value) -> None:
        path = os.path.join(self.root, META, "meta.json")
        meta = {}
        if os.path.exists(path):
            with open(path) as fh:
                meta = json.load(fh)
        meta[key] = value
        _dump_json(path, meta)

    def get_meta(self, key: str, default=None):
        path = os.path.join(self.root, META, "meta.json")
        if not os.path.exists(path):
            return default
        with open(path) as fh:
            return json.load(fh).get(key, default)


def shard_rows(n_rows: int, chunk_rows: int, writer_id: int,
               n_writers: int) -> Tuple[int, int]:
    """Chunk-aligned contiguous [lo, hi) row range of one writer.

    Chunks are dealt as evenly as possible; every boundary is a chunk
    boundary, so concurrent writers satisfy write_rows' alignment contract
    by construction."""
    n_chunks = -(-n_rows // chunk_rows)
    per = n_chunks // n_writers
    extra = n_chunks % n_writers
    first = writer_id * per + min(writer_id, extra)
    count = per + (1 if writer_id < extra else 0)
    # more writers than chunks: the tail writers own empty (clamped) ranges
    lo = min(first * chunk_rows, n_rows)
    hi = min((first + count) * chunk_rows, n_rows)
    return lo, hi


class ShardedReadView:
    """ArtifactStore-shaped read-only view over a ShardedArrayStore root,
    so downstream readers (_load_split, stats, resume checks) are
    format-agnostic: ``with open_for_read(path) as st: st.read(...)``."""

    def __init__(self, root: str):
        self._s = ShardedArrayStore(root)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def exists(self, name: str) -> bool:
        return self._s.exists(name)

    def read(self, name: str, start: Optional[int] = None,
             stop: Optional[int] = None) -> np.ndarray:
        if start is None:
            return self._s.read(name)
        return self._s.read(name, start, stop)

    def shape(self, name: str) -> Tuple[int, ...]:
        return self._s.shape(name)

    def iter_rows(self, name: str, block: int = 4096):
        n = self._s.shape(name)[0]
        for s in range(0, n, block):
            yield s, self._s.read(name, s, min(s + block, n))

    def get_meta(self, key: str, default=None):
        return self._s.get_meta(key, default)


def is_sharded_store(path: str) -> bool:
    """True for a ShardedArrayStore root (it holds ``_meta/``). An
    ArtifactStore kept as a directory of .npy files (data/npy_container.py)
    is a directory too, without ``_meta/``."""
    return os.path.isdir(os.path.join(path, META))


def open_for_read(path: str):
    """ShardedReadView for a sharded store, ArtifactStore otherwise (an
    HDF5 file or an npy-dir artifact)."""
    if is_sharded_store(path):
        return ShardedReadView(path)
    from .store import ArtifactStore

    return ArtifactStore(path, "r")
