"""The port's multi-writer store, sharded sweep checkpoint, sharded stage 3
and multi-process sweep, on the CPU.

One gloo world of 2 processes (tests/torch_distworker.py, suite "store")
writes one store from both processes at once, interrupts a sharded sweep
checkpoint with one process a wave behind, runs stage 3 sharded and a PR
sweep (interrupted, then resumed from the per-process sidecars) on a
workspace this file prepares. The store's reads are held against the JAX
package's tensorstore store on the same writes, ``shard_rows`` against
the JAX function, and the multi-process results against the port's
single-process ones.
"""

import json
import os

import numpy as np
import pytest
import torch

from opencv_dlco_tpu.data import shard_store as jax_store

from opencv_dlco_tpu_torch.cli import main as cli_main
from opencv_dlco_tpu_torch.data import store as port_store
from opencv_dlco_tpu_torch.data.shard_store import (
    ShardedArrayStore,
    ShardedReadView,
    open_for_read,
    shard_rows,
)
from opencv_dlco_tpu_torch.data.store import ArtifactStore
from opencv_dlco_tpu_torch.data.synthetic import synth_patch_pairs
from opencv_dlco_tpu_torch.models.pr_rda import PRState
from opencv_dlco_tpu_torch.parallel.sweep import run_pr_sweep
from opencv_dlco_tpu_torch.pipeline.stages import Workspace
from opencv_dlco_tpu_torch.utils.checkpoint import ShardedSweepCheckpoint
from opencv_dlco_tpu_torch.utils.configs import (
    PoolRegionConfig,
    PRLearnConfig,
    PRSweepGrid,
)

from torch_distworker import World

POOL = dict(patch_size=64, nr=6, nphi=2, nsigma=3)
PAIR_BLOCK = 32
PR = dict(n_iter=384, log_step=128, batch=32, max_dim=10_000,
          sampling="block", seed=2215)
GRID = dict(mus=(0.005, 0.02), gammas=(0.05, 0.2))


def _workspace(root, n_pairs=160):
    """A CPU workspace with dataset/synth.h5 (Brown layout) and the bank:
    stage 3's inputs (160 pairs: five 32-row chunks, dealt 3 + 2)."""
    p1, p2, labels = synth_patch_pairs(np.random.default_rng(99),
                                       n_pairs=n_pairs)
    n = len(labels)
    indices = np.zeros((n, 4), np.int32)
    indices[:, 0] = np.arange(n)
    indices[:, 1] = np.arange(n)
    indices[:, 2] = np.arange(n) + n
    indices[:, 3] = np.where(labels == 1, np.arange(n), np.arange(n) + n)
    with ArtifactStore(os.path.join(root, "dataset", "synth.h5"), "w") as st:
        st.write("Indices", indices)
        st.write("Patches", np.concatenate([p1, p2]), chunk_rows=256)
    ws = Workspace(root, pool_cfg=PoolRegionConfig(**POOL),
                   pair_block=PAIR_BLOCK, progress=False, device="cpu")
    ws.genpr()
    return ws


@pytest.fixture(scope="module")
def world_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("store_world"))
    _workspace(os.path.join(work, "ws"))
    np.savez(os.path.join(work, "inputs.npz"), root=work,
             pool=json.dumps(POOL), pair_block=PAIR_BLOCK,
             grid=json.dumps(GRID), pr=json.dumps(PR))
    w = World(2, "store", work)
    yield w, work
    w.ranks()


def test_roundtrip_and_idempotent_create(tmp_path):
    st = ShardedArrayStore(str(tmp_path / "s"))
    st.create("D", (20, 8), np.float32, chunk_rows=4)
    st.create("D", (20, 8), np.float32, chunk_rows=4)   # race-tolerant
    with pytest.raises(ValueError, match="exists as"):
        st.create("D", (24, 8), np.float32, chunk_rows=4)
    x = np.arange(160, dtype=np.float32).reshape(20, 8)
    st.write_rows("D", 0, x[:8])
    st.write_rows("D", 8, x[8:])                        # ends at boundary
    np.testing.assert_array_equal(st.read("D"), x)
    np.testing.assert_array_equal(st.read("D", 4, 12), x[4:12])
    assert st.shape("D") == (20, 8) and st.chunk_rows("D") == 4
    assert st.exists("D") and not st.exists("E")
    # a second handle on the same root sees the same array
    np.testing.assert_array_equal(ShardedArrayStore(st.root).read("D", 3, 5),
                                  x[3:5])


def test_alignment_contract(tmp_path):
    st = ShardedArrayStore(str(tmp_path / "s"))
    st.create("D", (20, 4), np.float32, chunk_rows=4)
    with pytest.raises(ValueError):
        st.write_rows("D", 2, np.zeros((4, 4), np.float32))   # bad start
    with pytest.raises(ValueError):
        st.write_rows("D", 0, np.zeros((6, 4), np.float32))   # bad length
    with pytest.raises(ValueError):
        st.write_rows("D", 16, np.zeros((8, 4), np.float32))  # past the end
    # a non-multiple length IS allowed when it ends at the array boundary
    st.write_rows("D", 16, np.ones((4, 4), np.float32))
    st.write_rows("D", 6, np.zeros((0, 4), np.float32))      # empty shard


def test_reads_match_the_jax_store(tmp_path):
    """The same creates and writes on the JAX package's tensorstore store
    and the port's npy store read back the same, never-written chunks
    (zeros) and partial ranges included."""
    x = np.random.default_rng(3).normal(size=(23, 5)).astype(np.float32)
    stores = [jax_store.ShardedArrayStore(str(tmp_path / "jax.zarr")),
              ShardedArrayStore(str(tmp_path / "port"))]
    for st in stores:
        st.create("D", (23, 5), np.float32, chunk_rows=4)
        st.write_rows("D", 0, x[:8])
        st.write_rows("D", 16, x[16:])
        st.create("L", (23, 1), np.int32, chunk_rows=4)
        st.write_rows("L", 4, np.arange(4, 12, dtype=np.int32)[:, None])
    for name in ("D", "L"):
        for lo, hi in ((0, None), (3, 9), (7, 23), (12, 16)):
            want = stores[0].read(name, lo, hi)
            got = stores[1].read(name, lo, hi)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert stores[1].shape(name) == stores[0].shape(name)
        assert stores[1].chunk_rows(name) == stores[0].chunk_rows(name)


@pytest.mark.parametrize("n_rows,chunk,n_w", [
    (100, 8, 3), (64, 64, 2), (7, 4, 4), (500_000, 256, 8), (160, 32, 2)])
def test_shard_rows_partition_matches_jax(n_rows, chunk, n_w):
    ranges = [shard_rows(n_rows, chunk, w, n_w) for w in range(n_w)]
    assert ranges == [jax_store.shard_rows(n_rows, chunk, w, n_w)
                      for w in range(n_w)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n_rows
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
    for lo, hi in ranges:
        assert lo <= hi and (lo == hi or lo % chunk == 0)


def test_done_markers_and_meta(tmp_path):
    st = ShardedArrayStore(str(tmp_path / "s"))
    assert not st.all_done(2)
    st.mark_done(0, {"rows": [0, 10]})
    assert not st.all_done(2)
    st.mark_done(1)
    assert st.all_done(2)
    st.set_meta("complete", True)
    st.set_meta("rows", [1, 2])
    assert st.get_meta("complete") is True and st.get_meta("rows") == [1, 2]
    assert st.get_meta("absent", 42) == 42
    with open(tmp_path / "s" / "_meta" / "done-0.json") as fh:
        assert json.load(fh) == {"writer": 0, "rows": [0, 10]}


def test_open_for_read_dispatch(tmp_path, monkeypatch):
    """A sharded store opens as a ShardedReadView; an HDF5 artifact and an
    npy-dir artifact (a directory too, without _meta/) as ArtifactStore."""
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    sh = str(tmp_path / "a.shards")
    sz = ShardedArrayStore(sh)
    sz.create("D", (6, 4), np.float32, chunk_rows=3)
    sz.write_rows("D", 0, x[:3])
    sz.write_rows("D", 3, x[3:])
    h5 = str(tmp_path / "a.h5")
    with ArtifactStore(h5, "w") as st:
        st.write("D", x)

    def check(path, kind):
        with open_for_read(path) as st:
            assert isinstance(st, kind), path
            np.testing.assert_array_equal(st.read("D"), x)
            assert st.shape("D") == (6, 4)
            blocks = list(st.iter_rows("D", block=4))
            assert blocks[0][0] == 0 and blocks[1][0] == 4
            np.testing.assert_array_equal(
                np.concatenate([b for _, b in blocks]), x)

    check(sh, ShardedReadView)
    check(h5, ArtifactStore)
    # without h5py the artifact is a directory of .npy files
    monkeypatch.setattr(port_store, "h5py", None)
    npy = str(tmp_path / "b.h5")
    with ArtifactStore(npy, "w") as st:
        st.write("D", x)
    assert os.path.isdir(npy)
    check(npy, ArtifactStore)
    check(sh, ShardedReadView)


def test_two_processes_write_one_store(world_run):
    w, work = world_run
    w.ranks()
    st = ShardedArrayStore(os.path.join(work, "conc"))
    assert st.all_done(2)
    np.testing.assert_array_equal(
        st.read("D"),
        np.arange(96, dtype=np.float32)[:, None] * np.ones(16, np.float32))


def test_sharded_checkpoint_assembles_the_common_wave(world_run):
    """Rank 1's file lags a wave: both ranks resume from wave 1 (every
    file has it), then from wave 2 once rank 1 caught up; the generator
    comes back in its saved state."""
    ranks = world_run[0].ranks()

    def wave(k):
        return np.arange(4.0)[:, None] + np.full((4, 3), float(k))

    for r in ranks:
        np.testing.assert_array_equal(
            r["ck_lag"], np.concatenate([[1, 100], wave(1).ravel(),
                                         np.full(4, 1.0)]))
        np.testing.assert_array_equal(
            r["ck_caught_up"], np.concatenate([[2, 200], wave(2).ravel(),
                                               np.full(4, 2.0)]))
        gen = torch.Generator().manual_seed(5)
        np.testing.assert_array_equal(
            r["ck_lag_draw"],
            torch.randint(0, 10**6, (4,), generator=gen).numpy())
    # cleanup() removed every process's file
    assert not os.listdir(os.path.join(world_run[1], "ck"))


def test_sharded_checkpoint_refuses_mismatched_sets(tmp_path):
    st = PRState(w=torch.ones(4, 2), df_avg=torch.zeros(4, 2), t=3)
    gen = torch.Generator().manual_seed(1)

    def pair(name):
        return [ShardedSweepCheckpoint(str(tmp_path / name), p, 2, 4)
                for p in range(2)]

    ck = pair("a")
    assert ck[0].load(PRState, {"a": 1}, device="cpu") is None  # no files
    ck[0].save(st, gen, {}, {"a": 1}, 1)
    assert ck[0].load(PRState, {"a": 1}, device="cpu") is None  # one file
    ck[1].save(st, gen, {}, {"a": 2}, 1)
    assert ck[0].load(PRState, {"a": 1}, device="cpu") is None  # signature
    ck = pair("b")
    ck[0].save(st, gen, {}, {"a": 1}, 1)
    ck[1].save(st, gen, {}, {"a": 1}, 2)
    ck[1].save(st, gen, {}, {"a": 1}, 3)
    assert ck[0].load(PRState, {"a": 1}, device="cpu") is None  # no common
    ck[0].save(st, gen, {}, {"a": 1}, 3)
    st_l, _, _, wave = ck[1].load(PRState, {"a": 1}, device="cpu")
    assert wave == 3 and st_l.t == 3
    np.testing.assert_array_equal(st_l.w.numpy(), np.ones((4, 2)))


@pytest.fixture(scope="module")
def single(world_run, tmp_path_factory):
    """The same workspace run in this one process: stage 3 single-writer
    and the PR sweep uninterrupted (started while the world runs)."""
    ws = _workspace(str(tmp_path_factory.mktemp("single")))
    dist = ws.compdist("synth")
    sweep = run_pr_sweep(ws, "synth", PRSweepGrid(**GRID),
                         PRLearnConfig(**PR))
    return ws, dist, sweep


def test_compdist_sharded_bit_equal_to_single_writer(world_run, single):
    ws1, dist1, _ = single
    ranks = world_run[0].ranks()
    path = str(ranks[0]["dist_path"])
    assert path.endswith("synth-dist.shards") and all(
        str(r["dist_path"]) == path for r in ranks)
    view = ShardedArrayStore(path)
    assert view.all_done(2)
    with open(os.path.join(path, "_meta", "done-1.json")) as fh:
        assert json.load(fh)["rows"] == [96, 160]
    with ArtifactStore(dist1, "r") as st:
        np.testing.assert_array_equal(view.read("Distance"),
                                      st.read("Distance"))
        np.testing.assert_array_equal(view.read("Label"), st.read("Label"))
    # the learners' loader reads either format into the same splits
    ws2 = Workspace(os.path.dirname(os.path.dirname(path)),
                    pool_cfg=PoolRegionConfig(**POOL), pair_block=PAIR_BLOCK,
                    progress=False, device="cpu")
    assert ws2.dist_path("synth") == path
    a = ws2._load_split(path, 0.8, 7)
    b = ws1._load_split(dist1, 0.8, 7)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_two_rank_pr_sweep_primary_writes_and_matches_one_process(
        world_run, single):
    _, _, sweep1 = single
    ranks = world_run[0].ranks()
    # interrupted after one log: one sidecar per process, then none
    assert json.loads(str(ranks[0]["sidecars"])) == [
        "synth-sweep-ckpt-p0of2.h5", "synth-sweep-ckpt-p1of2.h5"]
    root = os.path.join(world_run[1], "ws", "pr-learn")
    assert not [f for f in os.listdir(root) if "sweep-ckpt" in f]
    runs = [json.loads(str(r["sweep"])) for r in ranks]
    assert runs[0] == runs[1]
    assert [(r["mu"], r["gamma"], r["obj"], r["nnz"]) for r in runs[0]] == \
        [(r["mu"], r["gamma"], r["obj"], r["nnz"]) for r in sweep1]
    # one artifact per combo, written by the primary, equal to one process's
    arts = sorted(f for f in os.listdir(root) if f.endswith("-pr.h5"))
    assert len(arts) == 4
    for r1 in sweep1:
        name = os.path.basename(r1["model"])
        with ArtifactStore(os.path.join(root, name), "r") as a, \
                ArtifactStore(r1["model"], "r") as b:
            np.testing.assert_array_equal(a.read("w"), b.read("w"))
            assert a.get_meta("done_iters") == b.get_meta("done_iters")
    with open(os.path.join(root, "logging", "synth-sweep.jsonl")) as fh:
        assert len(fh.read().strip().splitlines()) >= 3


def test_dist_info_cpu(capsys, monkeypatch):
    for var in ("DLCO_NUM_PROCESSES", "DLCO_PROCESS_ID", "DLCO_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    cli_main(["dist-info", "--device", "cpu"])
    info = json.loads(capsys.readouterr().out)
    assert info == {"multi_process": False, "process_index": 0,
                    "process_count": 1, "local_device_count": 1,
                    "global_device_count": 1, "backend": "cpu"}


def test_distributed_flag_joins_a_torchrun_world(monkeypatch, capsys):
    """``--distributed`` reads a launcher's variables: two ``dist-info``
    processes given only torchrun's WORLD_SIZE/RANK/MASTER_ADDR/MASTER_PORT
    form one gloo world of two; without the flag those variables start
    nothing."""
    import socket
    import subprocess
    import sys

    for var in ("DLCO_NUM_PROCESSES", "DLCO_PROCESS_ID", "DLCO_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    torchrun = dict(WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=port)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "opencv_dlco_tpu_torch.cli", "--distributed",
         "dist-info", "--device", "cpu"], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict({k: v for k, v in os.environ.items()
                  if not k.startswith("DLCO_")}, **torchrun, RANK=str(r),
                 OMP_NUM_THREADS="1")) for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    for rank, text in enumerate(outs):
        info = json.loads(text[text.index("{"):])
        assert info["multi_process"] is True and info["backend"] == "gloo"
        assert (info["process_index"], info["process_count"]) == (rank, 2)
    for var, value in dict(torchrun, RANK="1").items():
        monkeypatch.setenv(var, value)
    cli_main(["dist-info", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["process_count"] == 1


def test_rank_logs_are_clean(world_run):
    """Both ranks ended without a traceback in their logs."""
    world_run[0].ranks()
    for r in range(2):
        with open(os.path.join(world_run[1], f"rank{r}.log")) as fh:
            assert "Traceback" not in fh.read()
