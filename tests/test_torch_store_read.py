"""Whole-dataset reads from a directory of .npy files hold one copy.

Without h5py the port's store keeps each artifact as a directory of .npy
files (``data/npy_container.NpyDirFile``). At the ``e2e`` command's
default shape (500,000 pairs a dataset) the stage-3 matrix is 10.24 GB
and the patches 4.1 GB; compdist, compunproj, prstats and pjstats read
them whole. These tests count the bytes numpy allocates for such a read
(``tracemalloc``, which sees numpy's data buffers): at most
``COPY_MULTIPLE`` times the dataset, so one copy of the file, not a load
followed by a second full copy. Slices still come out of the memory map as
arrays of their own. prstats and pjstats, which read one such matrix a
dataset, hold one at a time.
"""

import tracemalloc

import numpy as np
import pytest
import torch

import opencv_dlco_tpu_torch.data.store as store
from opencv_dlco_tpu_torch.data.npy_container import NpyDirFile
from opencv_dlco_tpu_torch.data.store import ArtifactStore
from opencv_dlco_tpu_torch.models.select import (compute_pj_stats,
                                                 compute_pr_stats_rows)
from opencv_dlco_tpu_torch.pipeline.stages import Workspace
from opencv_dlco_tpu_torch.utils.configs import PoolRegionConfig

from test_torch_pipeline import POOL

#: bytes numpy allocates for a whole read, at most this multiple of the
#: dataset's size (one copy plus slack for small temporaries)
COPY_MULTIPLE = 1.25


def _peak_bytes(fn):
    """(fn's result, the peak of bytes traced while it ran)."""
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        before = tracemalloc.get_traced_memory()[0]
        out = fn()
        peak = tracemalloc.get_traced_memory()[1] - before
    finally:
        tracemalloc.stop()
    return out, peak


@pytest.mark.parametrize("name,shape,dtype", [
    ("Distance", (4096, 512), np.float32),     # a stage-3 matrix
    ("Patches", (512, 64, 64), np.uint8),      # a dataset's patches
])
def test_whole_read_holds_one_copy(tmp_path, monkeypatch, name, shape,
                                   dtype):
    monkeypatch.setattr(store, "h5py", None)
    data = np.random.default_rng(7).integers(0, 200, size=shape).astype(
        dtype)
    path = str(tmp_path / "a.h5")
    with ArtifactStore(path, "w") as st:
        st.write(name, data, compression=0)
    with ArtifactStore(path, "r") as st:
        got, peak = _peak_bytes(lambda: st.read(name))
    assert isinstance(st._f, NpyDirFile)
    np.testing.assert_array_equal(got, data)
    assert got.flags.writeable and got.flags.owndata
    assert peak <= COPY_MULTIPLE * data.nbytes, (peak, data.nbytes)


def test_slices_are_arrays_of_their_own(tmp_path, monkeypatch):
    monkeypatch.setattr(store, "h5py", None)
    data = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    path = str(tmp_path / "a.h5")
    with ArtifactStore(path, "w") as st:
        st.write("Distance", data, compression=0)
    with ArtifactStore(path, "r") as st:
        rows = st.read("Distance", 8, 24)
        blocks = list(st.iter_rows("Distance", block=16))
    np.testing.assert_array_equal(rows, data[8:24])
    assert rows.base is None or rows.flags.owndata
    assert not isinstance(rows, np.memmap)
    assert [s for s, _ in blocks] == [0, 16, 32, 48]
    np.testing.assert_array_equal(np.concatenate([b for _, b in blocks]),
                                  data)


def _stats_inputs(ws, stage, rng):
    """Two datasets' matrices of 16 MB each and one model for ``stage``:
    (paths of the matrices by dataset, model paths, the matrices, labels,
    the model's weights)."""
    n_feat = ws.pool_cfg.n_rings if stage == "prstats" else 64
    n_rows = max(4096, (16 << 20) // (4 * n_feat))
    labels = (np.arange(n_rows) % 2).astype(np.int32).reshape(-1, 1)
    paths, mats = {}, {}
    for ds in ("syn-a", "syn-b"):
        mats[ds] = rng.random((n_rows, n_feat), dtype=np.float32)
        name = f"{ds}-dist.h5" if stage == "prstats" else f"{ds}-unproj.h5"
        paths[ds] = ws.path("distances", name)
        with ArtifactStore(paths[ds], "w") as st:
            st.write("Label", labels)
            st.write("Distance", mats[ds], compression=0)
    if stage == "prstats":
        model = np.where(rng.random((3, n_feat)) < 0.2,
                         rng.random((3, n_feat)), 0.0).astype(np.float32)
        mpath = ws.path("pr-learn", "syn-a-0.01-0.1-pr.h5")
        with ArtifactStore(mpath, "w") as st:
            for row in model:
                st.append_row("w", row)
    else:
        model = rng.standard_normal((8, n_feat)).astype(np.float32)
        mpath = ws.path("pj-learn", "syn-a-0.001-0.25-pj.h5")
        with ArtifactStore(mpath, "w") as st:
            st.write("W", model)
    return paths, [mpath], mats, labels.reshape(-1), model


@pytest.mark.parametrize("stage", ["prstats", "pjstats"])
def test_stats_hold_one_matrix_at_a_time(tmp_path, monkeypatch, stage):
    """prstats and pjstats read each dataset's matrix whole and upload it:
    on the host that is one copy of one matrix at a time (the read holds no
    second copy, and the last dataset's matrix is dropped before the next
    is read). On the CPU the upload is the numpy array itself, so the
    bytes traced are the matrices' own; on the card the same release
    keeps one matrix resident."""
    monkeypatch.setattr(store, "h5py", None)
    ws = Workspace(str(tmp_path), pool_cfg=PoolRegionConfig(**POOL),
                   progress=False, device="cpu")
    ws.genpr()
    paths, models, mats, labels, model = _stats_inputs(
        ws, stage, np.random.default_rng(3))

    records, peak = _peak_bytes(
        lambda: getattr(ws, stage)(models, paths))
    labels_t = torch.from_numpy(labels)
    for ds, mat in mats.items():
        got = [r["fpr95"] for r in records if r["dataset"] == ds]
        if stage == "prstats":
            want = [w["fpr95"] for w in compute_pr_stats_rows(
                ws.load_pr_params(), torch.from_numpy(mat), labels_t,
                model)]
        else:
            want = [compute_pj_stats(torch.from_numpy(mat), labels_t,
                                     model)["fpr95"]]
        assert got == want, ds
    matrix = next(iter(mats.values())).nbytes
    assert peak <= COPY_MULTIPLE * matrix, (peak, matrix)
