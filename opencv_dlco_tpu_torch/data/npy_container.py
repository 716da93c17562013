"""A directory of .npy files that stands in for an HDF5 file without h5py.

``data/store.ArtifactStore`` speaks to its container through the small part
of the ``h5py.File`` interface it uses: membership, dataset get/create/
delete, dataset shape, slicing, row assignment and ``resize``, ``attrs``
and ``flush``. Where h5py is not installed (the CUDA host this port runs
on has none), ``NpyDirFile`` provides that interface over a directory at
the artifact's path: each dataset is ``<name>.npy`` (a name with "/" is a
subdirectory), attributes are ``attrs.json``. Dataset names, shapes,
dtypes and attribute values are the HDF5 schema's; gzip chunking is not
kept. Row reads and writes go through memory maps, so the streamed
Distance matrix is never resident, and a resize rewrites the header in
place, so appending N rows to a history writes O(N) bytes.
"""

from __future__ import annotations

import io
import json
import os
import shutil
from typing import Optional

import numpy as np

_ATTRS = "attrs.json"
#: .npy format version -> (header reader, header writer)
_HEADER = {
    (1, 0): (np.lib.format.read_array_header_1_0,
             np.lib.format.write_array_header_1_0),
    (2, 0): (np.lib.format.read_array_header_2_0,
             np.lib.format.write_array_header_2_0),
}


class _Attrs:
    """dict-like attributes persisted to attrs.json on every assignment."""

    def __init__(self, root: str, writable: bool):
        self._path = os.path.join(root, _ATTRS)
        self._writable = writable
        self._d = {}
        if os.path.exists(self._path):
            with open(self._path) as fh:
                self._d = json.load(fh)

    def __contains__(self, key) -> bool:
        return key in self._d

    def __getitem__(self, key):
        return self._d[key]

    def __setitem__(self, key, value) -> None:
        if not self._writable:
            raise OSError("attribute write on a read-only container")
        self._d[key] = value
        tmp = self._path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._d, fh)
        os.replace(tmp, self._path)


class NpyDataset:
    """One dataset: an .npy file, sliced through a memory map."""

    def __init__(self, path: str):
        self._path = path

    @property
    def shape(self):
        with open(self._path, "rb") as fh:
            version = np.lib.format.read_magic(fh)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            return read(fh)[0]

    def _map(self, mode: str):
        return np.load(self._path, mmap_mode=mode, allow_pickle=False)

    def __getitem__(self, idx):
        """A whole read is ``np.load``'s own array: one copy of the file,
        not two (a stage-3 matrix is 10.24 GB at 500,000 pairs). A slice
        is copied out of the memory map."""
        if idx is Ellipsis:
            return np.load(self._path, allow_pickle=False)
        return np.array(self._map("r")[idx])

    def __setitem__(self, idx, value) -> None:
        mm = self._map("r+")
        mm[idx] = value
        mm.flush()

    def resize(self, n: int, axis: int = 0) -> None:
        """Grow or shrink the leading axis in place: the header is rewritten
        at its own length (numpy's writer leaves room in it for a longer
        leading axis) and the file is cut, or extended with zero rows, so
        an append writes its row and not the history. A header with no
        such room, or a Fortran-ordered array, is rewritten whole."""
        if axis != 0:
            raise ValueError("only the leading axis can be resized")
        with open(self._path, "rb") as fh:
            version = np.lib.format.read_magic(fh)
            if version in _HEADER:
                shape, fortran, dtype = _HEADER[version][0](fh)
                offset = fh.tell()
                head = io.BytesIO()
                _HEADER[version][1](head, {
                    "descr": np.lib.format.dtype_to_descr(dtype),
                    "fortran_order": False, "shape": (n,) + shape[1:]})
        if version in _HEADER and not fortran and head.tell() == offset:
            row_bytes = dtype.itemsize * int(np.prod(shape[1:]))
            with open(self._path, "r+b") as fh:
                fh.write(head.getvalue())
                fh.truncate(offset + n * row_bytes)
            return
        old = np.load(self._path, allow_pickle=False)
        new = np.zeros((n,) + old.shape[1:], old.dtype)
        k = min(n, old.shape[0])
        new[:k] = old[:k]
        _save(self._path, new)


def _save(path: str, arr: np.ndarray) -> None:
    tmp = path + ".tmp.npy"
    np.save(tmp, arr, allow_pickle=False)
    os.replace(tmp, path)


class NpyDirFile:
    """The subset of ``h5py.File`` that ArtifactStore uses, over a directory."""

    def __init__(self, path: str, mode: str = "a"):
        if mode not in ("r", "a", "w"):
            raise ValueError(f"unsupported mode {mode!r}")
        self._root = path
        if mode == "r" and not os.path.isdir(path):
            raise FileNotFoundError(f"no artifact directory at {path}")
        if mode == "w" and os.path.lexists(path):
            remove(path)
        if mode != "r":
            os.makedirs(path, exist_ok=True)
        self.attrs = _Attrs(path, writable=mode != "r")

    def _file(self, name: str) -> str:
        return os.path.join(self._root, *name.split("/")) + ".npy"

    def __contains__(self, name: str) -> bool:
        return os.path.exists(self._file(name))

    def __getitem__(self, name: str) -> NpyDataset:
        if name not in self:
            raise KeyError(name)
        return NpyDataset(self._file(name))

    def __delitem__(self, name: str) -> None:
        os.remove(self._file(name))

    def create_dataset(self, name: str, data: Optional[np.ndarray] = None,
                       shape=None, dtype=None, **_ignored) -> NpyDataset:
        """``chunks``, ``maxshape`` and ``compression*`` are HDF5 layout
        options with no counterpart here; every dataset can be resized."""
        path = self._file(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if data is not None:
            _save(path, np.asarray(data))
        else:
            mm = np.lib.format.open_memmap(path, mode="w+", dtype=dtype,
                                           shape=tuple(shape))
            mm.flush()
            del mm
        return NpyDataset(path)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def remove(path: str) -> None:
    """Delete an artifact, whichever container holds it."""
    if os.path.isdir(path) and not os.path.islink(path):
        shutil.rmtree(path)
    else:
        os.remove(path)
