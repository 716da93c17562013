"""Artifact store: reference-schema HDF5 datasets + chunked streaming.

The reference's L0 layer is opencv_hdf's dscreate/dswrite/dsread/dsinsert
over gzip-9 chunked HDF5 (reference: src/conv-impatches.cpp:120-189,
src/pr-learn.cpp:394-410). This store speaks the same on-disk schema
(`Indices`, `Patches`, `Label`, `Distance`, `RingParams`, `PRParams`,
`PRFilters`, `w`, `W`, `A`) so reference-produced files load directly, and
adds:

- append-mode model histories (the reference's H5_UNLIMITED "w" dataset —
  every improving checkpoint is a new row, addressed downstream as
  `file.h5#row`);
- a chunk-streaming writer for the 500k x 5120 Distance matrix so it is
  produced tile-by-tile from device without ever being resident;
- JSON attribute metadata (configs, provenance) the reference keeps in
  filenames and logs.

A copy of ``opencv_dlco_tpu/data/store.py``. Where h5py is not installed
the same store keeps each artifact as a directory of .npy files at the
artifact's path (data/npy_container.py): same dataset names, shapes,
dtypes and metadata, without HDF5's container. ``BACKEND`` names the one
in use.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from .npy_container import NpyDirFile, remove

try:
    import h5py
except ImportError:  # hosts without h5py keep artifacts as .npy directories
    h5py = None

#: container of every artifact this process writes or reads
BACKEND = "hdf5" if h5py is not None else "npy-dir"

DEFAULT_CHUNK = 128  # reference sChunk (src/pr-learn.cpp:60)


class ArtifactStore:
    """One HDF5 artifact file with reference-compatible dataset layout."""

    def __init__(self, path: str, mode: str = "a"):
        self.path = path
        if mode != "r":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = (h5py.File(path, mode) if h5py is not None
                   else NpyDirFile(path, mode))

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def exists(self, name: str) -> bool:
        return name in self._f

    # -- whole-dataset access ---------------------------------------------

    def write(self, name: str, data: np.ndarray,
              chunk_rows: int = DEFAULT_CHUNK, compression: int = 9) -> None:
        data = np.asarray(data)
        if name in self._f:
            del self._f[name]
        if data.ndim == 0 or data.size == 0:
            # scalars / empty arrays: no chunking or compression
            self._f.create_dataset(name, data=data)
        else:
            chunks = (min(chunk_rows, data.shape[0]),) + data.shape[1:]
            self._f.create_dataset(
                name, data=data, chunks=chunks,
                compression="gzip", compression_opts=compression,
            )
        self._f.flush()

    def read(self, name: str, start: Optional[int] = None,
             stop: Optional[int] = None) -> np.ndarray:
        ds = self._f[name]
        if start is None:
            return ds[...]
        return ds[start:stop]

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._f[name].shape)

    # -- streamed creation (the Distance matrix path) ---------------------

    def create(self, name: str, shape: Sequence[int], dtype,
               chunk_rows: int = DEFAULT_CHUNK, compression: int = 9) -> None:
        if name in self._f:
            del self._f[name]
        chunks = (min(chunk_rows, shape[0]),) + tuple(shape[1:])
        self._f.create_dataset(
            name, shape=tuple(shape), dtype=dtype, chunks=chunks,
            compression="gzip", compression_opts=compression,
        )

    def write_rows(self, name: str, start: int, rows: np.ndarray) -> None:
        self._f[name][start:start + rows.shape[0]] = rows

    def iter_rows(self, name: str,
                  block: int = 4096) -> Iterator[Tuple[int, np.ndarray]]:
        ds = self._f[name]
        for s in range(0, ds.shape[0], block):
            yield s, ds[s:s + block]

    # -- append-mode model history (H5_UNLIMITED "w") ---------------------

    def append_row(self, name: str, row: np.ndarray) -> int:
        """Append one row to an unlimited dataset; returns its row index.

        Mirrors the reference's improving-checkpoint protocol
        (src/pr-learn.cpp:396-407): the dataset is a history, downstream
        stages address a specific row.
        """
        row = np.asarray(row).reshape(1, -1)
        if name not in self._f:
            self._f.create_dataset(
                name, data=row, maxshape=(None, row.shape[1]),
                chunks=(1, row.shape[1]), compression="gzip",
                compression_opts=9,
            )
            self._f.flush()
            return 0
        ds = self._f[name]
        n = ds.shape[0]
        ds.resize(n + 1, axis=0)
        ds[n] = row[0]
        self._f.flush()
        return n

    def truncate_rows(self, name: str, n_rows: int) -> None:
        """Shrink an unlimited dataset to its first n_rows.

        Resume safety: a crash between an append and the next sweep
        checkpoint leaves rows the checkpoint doesn't know about; the
        resuming run trims to the checkpointed count so the replayed
        appends don't duplicate.
        """
        if name not in self._f:
            return
        ds = self._f[name]
        if ds.shape[0] > n_rows:
            ds.resize(n_rows, axis=0)
            self._f.flush()

    # -- metadata ---------------------------------------------------------

    def set_meta(self, key: str, value) -> None:
        self._f.attrs[key] = json.dumps(value)

    def get_meta(self, key: str, default=None):
        if key not in self._f.attrs:
            return default
        return json.loads(self._f.attrs[key])


class NullStore:
    """Write-sink with the ArtifactStore interface: every mutation is a
    no-op and every read reports emptiness.

    Handed to non-primary processes of a multi-host run in place of a real
    writer (parallel/distributed.is_primary): the compute path stays
    byte-identical across processes — mandatory, since sharded programs
    are collective — while only host 0 touches the artifact files (two
    processes appending to one HDF5 file would corrupt it; reference
    analogue: none, the reference is single-process, SURVEY.md §2)."""

    def __init__(self, path: str):
        self.path = path

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def exists(self, name: str) -> bool:
        return False

    def write(self, name, data, chunk_rows=None, compression=None) -> None:
        pass

    def create(self, name, shape, dtype, chunk_rows=None,
               compression=None) -> None:
        pass

    def write_rows(self, name, start, rows) -> None:
        pass

    def append_row(self, name, row) -> int:
        return 0

    def truncate_rows(self, name, n_rows) -> None:
        pass

    def set_meta(self, key, value) -> None:
        pass

    def get_meta(self, key, default=None):
        return default

    def read(self, name, start=None, stop=None):
        raise RuntimeError(
            "NullStore is write-only: non-primary processes must not read "
            f"artifacts they never wrote ({self.path}:{name})")

    shape = read
    iter_rows = read


def writer_store(path: str, mode: str = "a"):
    """ArtifactStore on the primary process, NullStore elsewhere.

    The multi-host write-discipline chokepoint: stage/sweep writers open
    their output through this so a 2+-process run produces exactly one
    copy of every artifact (see tests/test_distributed_procs.py)."""
    from ..parallel.distributed import is_primary

    return ArtifactStore(path, mode) if is_primary() else NullStore(path)


def remove_artifact(path: str) -> None:
    """Delete an artifact file (or directory, for the npy-dir backend)."""
    remove(path)


def parse_model_ref(ref: str) -> Tuple[str, int]:
    """Split the reference's `path.h5#row` checkpoint address convention
    (workspace/07-compunproj.sh:10-17); row defaults to the last one (-1)."""
    if "#" in ref:
        path, row = ref.rsplit("#", 1)
        return path, int(row)
    return ref, -1
