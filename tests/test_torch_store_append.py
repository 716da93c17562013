"""Appending to a history kept as a directory of .npy files.

Without h5py the port's store keeps each artifact as a directory of .npy
files (``data/npy_container.NpyDirFile``). A sweep appends one w row per
improving log period to each combo's history; these tests hold the
container's append, truncate and read paths to the HDF5 container on the
same calls, and count the bytes the appends write: N appends must write
O(N) bytes (under ``WRITE_MULTIPLE`` times the history's final size), not
rewrite the history on every append.
"""

import builtins
import os

import numpy as np
import pytest

import opencv_dlco_tpu_torch.data.store as store
from opencv_dlco_tpu_torch.data import npy_container
from opencv_dlco_tpu_torch.data.npy_container import NpyDirFile
from opencv_dlco_tpu_torch.data.store import ArtifactStore
from opencv_dlco_tpu_torch.parallel.sweep import run_pr_sweep
from opencv_dlco_tpu_torch.pipeline.stages import Workspace
from opencv_dlco_tpu_torch.utils import configs as pcfg
from opencv_dlco_tpu_torch.utils.checkpoint import RunInterrupted

from test_torch_pipeline import POOL, PR, GRID, _write_dataset
from test_torch_rda import JaxDraws

N_APPENDS = 500
WIDTH = 5120
#: bytes written by N_APPENDS appends, at most this multiple of the
#: history's final size (each row once, plus a 128-byte header an append)
WRITE_MULTIPLE = 1.1


def _rows(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, WIDTH)).astype(np.float32)


def _append(f, name, row):
    """ArtifactStore.append_row's calls on its container."""
    row = np.asarray(row).reshape(1, -1)
    if name not in f:
        f.create_dataset(name, data=row, maxshape=(None, row.shape[1]))
        return
    ds = f[name]
    n = ds.shape[0]
    ds.resize(n + 1, axis=0)
    ds[n] = row[0]


class _Counting:
    """A file object that counts the bytes handed to its write()."""

    def __init__(self, fh, counter):
        self._fh = fh
        self._counter = counter

    def write(self, data):
        self._counter[0] += len(data)
        return self._fh.write(data)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._fh.close()

    def __getattr__(self, name):
        return getattr(self._fh, name)


@pytest.fixture
def bytes_written(monkeypatch):
    """Counts every byte written through open() while the test runs, and
    the bytes of every value a dataset assigns through its memory map."""
    counter = [0]
    real_open = builtins.open
    real_setitem = npy_container.NpyDataset.__setitem__

    def counting_setitem(ds, idx, value):
        counter[0] += np.asarray(value).nbytes
        real_setitem(ds, idx, value)

    def counting_open(file, mode="r", *a, **kw):
        fh = real_open(file, mode, *a, **kw)
        if any(c in mode for c in "wax+"):
            return _Counting(fh, counter)
        return fh

    monkeypatch.setattr(builtins, "open", counting_open)
    monkeypatch.setattr(npy_container.NpyDataset, "__setitem__",
                        counting_setitem)
    return counter


def test_500_appends_equal_the_stack_and_write_linear_bytes(tmp_path,
                                                           bytes_written):
    rows = _rows(N_APPENDS)
    f = NpyDirFile(str(tmp_path / "run.h5"), "w")
    before = bytes_written[0]
    for r in rows:
        _append(f, "w", r)
    written = bytes_written[0] - before
    assert f["w"].shape == rows.shape
    np.testing.assert_array_equal(f["w"][...], rows)
    np.testing.assert_array_equal(f["w"][17:230], rows[17:230])
    np.testing.assert_array_equal(f["w"][-1], rows[-1])
    assert written <= WRITE_MULTIPLE * rows.nbytes, (written, rows.nbytes)
    # a reopened container, read-only, sees the same history
    g = NpyDirFile(str(tmp_path / "run.h5"), "r")
    assert g["w"].shape == rows.shape
    np.testing.assert_array_equal(g["w"][...], rows)


def test_truncate_then_reappend_equals_the_stack(tmp_path):
    first, second = _rows(300, seed=1), _rows(380, seed=2)
    f = NpyDirFile(str(tmp_path / "run.h5"), "w")
    for r in first:
        _append(f, "w", r)
    f["w"].resize(120)
    assert f["w"].shape == (120, WIDTH)
    for r in second:
        _append(f, "w", r)
    want = np.concatenate([first[:120], second])
    np.testing.assert_array_equal(f["w"][...], want)
    # growing exposes zero rows, as HDF5 does
    f["w"].resize(want.shape[0] + 3)
    assert not f["w"][want.shape[0]:].any()


def test_resize_without_header_room_rewrites_the_file(tmp_path):
    """A Fortran-ordered dataset cannot grow in place: resize rewrites it,
    and keeps its rows."""
    rows = _rows(5, seed=4)[:, :8]
    f = NpyDirFile(str(tmp_path / "run.h5"), "w")
    f.create_dataset("w", data=np.asfortranarray(rows))
    f["w"].resize(7)
    assert f["w"].shape == (7, 8)
    np.testing.assert_array_equal(f["w"][:5], rows)
    assert not f["w"][5:].any()
    f["w"][6] = rows[0]
    f["w"].resize(2)
    np.testing.assert_array_equal(f["w"][...], rows[:2])


def _history_ops(st, rows):
    """One script of appends, truncations and reads; returns what the
    store's readers return after each step."""
    seen = []

    def look():
        seen.append((st.shape("w"), st.read("w"),
                     [(s, b) for s, b in st.iter_rows("w", block=7)]))

    for r in rows[:40]:
        st.append_row("w", r)
    look()
    st.truncate_rows("w", 25)
    look()
    st.truncate_rows("w", 30)        # no-op: longer than the history
    for r in rows[40:]:
        st.append_row("w", r)
    look()
    st.truncate_rows("w", 0)
    look()
    st.append_row("w", rows[0])
    look()
    return seen


def test_store_history_paths_equal_hdf5(tmp_path, monkeypatch):
    """append_row, truncate_rows, read, shape and iter_rows return the
    same on both containers, across a reopen."""
    rows = _rows(100, seed=3)[:, :64]
    with ArtifactStore(str(tmp_path / "h5" / "run.h5"), "w") as st:
        want = _history_ops(st, rows)
    monkeypatch.setattr(store, "h5py", None)
    path = str(tmp_path / "npy" / "run.h5")
    with ArtifactStore(path, "w") as st:
        got = _history_ops(st, rows)
    assert os.path.isdir(path)
    for (sg, rg, ig), (sw, rw, iw) in zip(got, want):
        assert sg == sw
        np.testing.assert_array_equal(rg, rw)
        assert [s for s, _ in ig] == [s for s, _ in iw]
        for (_, bg), (_, bw) in zip(ig, iw):
            np.testing.assert_array_equal(bg, bw)
    with ArtifactStore(path, "r") as st:
        np.testing.assert_array_equal(st.read("w"), want[-1][1])
    # a dataset written whole over a grown one of the same name replaces it
    with ArtifactStore(path, "a") as st:
        st.write("w", rows[:5])
        assert st.shape("w") == (5, 64)
        np.testing.assert_array_equal(st.read("w"), rows[:5])


def test_sweep_resume_on_npy_dirs_equals_uninterrupted(tmp_path,
                                                       monkeypatch):
    """run_pr_sweep stopped after two log periods and resumed (rows
    truncated to the checkpoint's counts, then appended again) writes the
    histories of an uninterrupted sweep, with artifacts as .npy dirs."""
    monkeypatch.setattr(store, "h5py", None)
    grid, base = pcfg.PRSweepGrid(**GRID), pcfg.PRLearnConfig(**PR)
    hist = {}
    for tag in ("resumed", "fresh"):
        root = str(tmp_path / tag)
        _write_dataset(root)
        ws = Workspace(root, pool_cfg=pcfg.PoolRegionConfig(**POOL),
                       pair_block=64, progress=False, device="cpu")
        ws.compdist("synth")
        JaxDraws(PR["seed"]).install(monkeypatch)
        if tag == "resumed":
            with pytest.raises(RunInterrupted):
                run_pr_sweep(ws, "synth", grid, base, _stop_after_logs=2)
        res = run_pr_sweep(ws, "synth", grid, base)
        hist[tag] = {}
        for r in res:
            with ArtifactStore(r["model"], "r") as st:
                hist[tag][os.path.basename(r["model"])] = (
                    st.read("w") if st.exists("w") else None)
    assert sorted(hist["resumed"]) == sorted(hist["fresh"])
    assert any(h is not None and h.shape[0] > 1
               for h in hist["fresh"].values())
    for name, h in hist["fresh"].items():
        if h is None:
            assert hist["resumed"][name] is None
        else:
            np.testing.assert_array_equal(hist["resumed"][name], h)
