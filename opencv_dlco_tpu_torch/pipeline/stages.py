"""The 11-stage DLCO workflow on CUDA devices.

Port of ``opencv_dlco_tpu/pipeline/stages.py``: every stage is a method
over a Workspace directory with the reference's artifact layout and resume
contract (a stage is skipped iff its output artifact is complete),
structured JSONL metrics, and device-batched compute.

Workspace layout (mirrors reference workspace/, the same files the JAX
package writes):
    dataset/{ds}.h5                  Indices + Patches        (stage 1)
    filters.h5                       Ring/PR params + filters (stage 2)
    distances/{ds}-dist.h5           Label + Distance         (stage 3)
    distances/{ds}-dist.shards/      the same, multi-writer   (stage 3,
                                     several processes; data/shard_store.py)
    pr-learn/{run}.h5 + logging/     w histories + metrics    (stage 4)
    distances/{ds}-{pr}-unproj.h5    signed diff vectors      (stage 7)
    pj-learn/{run}.h5 + logging/     W, A + metrics           (stage 8)
    opencv/*.i                       exported headers         (stage 11)
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.brown import convert_brown_patches, pair_labels
from ..data.shard_store import (
    ShardedArrayStore,
    is_sharded_store,
    open_for_read,
    shard_rows,
)
from ..data.store import (
    ArtifactStore,
    parse_model_ref,
    remove_artifact,
    writer_store,
)
from ..models import pj_rda
from ..models.pr_rda import PRState, pr_init, pr_train_chunk, pr_validate
from ..models.select import (
    compute_pj_stats,
    compute_pj_stats_splits,
    compute_pr_stats_rows,
    compute_pr_stats_splits,
    select_pr_filters,
)
from ..ops.pair_distance import ring_distances, unprojected_diffs
from ..ops.pair_distance_fused import (TF, TK, kernel_bank,
                                       ring_distances_fused)
from ..ops.patch_transform import batch_patch_transform
from ..ops.pool_regions import build_filter_bank
from ..parallel.distributed import (
    is_primary,
    process_count,
    process_index,
)
from ..utils.checkpoint import (
    RunInterrupted,
    is_lock_error,
    load_solver_state,
    open_lock_retry,
    save_solver_state,
)
from ..utils.configs import (
    DescriptorConfig,
    PJLearnConfig,
    PoolRegionConfig,
    PRLearnConfig,
)
from ..utils.logs import MetricLogger
from ..utils.memory import check_device_budget, nbytes
from ..utils.progress import TermProgress


def _open_if_sound(path: str):
    """ArtifactStore(path, "r"), or None for a truncated/corrupt file.

    Idempotence probes treat an HDF5 a killed run left mid-write exactly
    like an incomplete marker. Lock contention is not corruption: the open
    retries while another process holds the file, and raises if the lock
    outlasts the retry window, so a healthy artifact is never deleted."""
    try:
        return open_lock_retry(path, "r")
    except OSError as err:
        if is_lock_error(err):
            raise
        return None


def stage3_route(matmul_precision: str, bank_shape, cuda: bool) -> str:
    """The ring-distance route of stage 3 for a bank of ``bank_shape``
    (n_filters, n_pixels), on a CUDA device or not: kernel A where the bank
    fits its tiles, in its bf16 mode ("kernel_A") at any precision but
    "highest" and, on a CUDA device, in its f32 mode ("kernel_A_f32") at
    "highest"; else the f32 product of ops/pair_distance.py ("f32"). Off
    the card kernel A's f32 mode is that product itself, so "highest"
    takes it directly there."""
    nf, npix = bank_shape
    if nf % TF or npix % TK:
        return "f32"
    if matmul_precision != "highest":
        return "kernel_A"
    return "kernel_A_f32" if cuda else "f32"


def stage3_distances(filters, route: str, pt1, pt2):
    """One block's ring distances on ``route``, the bank as
    ``Workspace._stage3_bank`` prepared it."""
    if route == "f32":
        return ring_distances(filters, pt1, pt2)
    return ring_distances_fused(filters, pt1, pt2, bf16=route == "kernel_A")


@dataclass
class Workspace:
    """A pipeline working directory with reference-compatible layout."""

    root: str
    desc_cfg: DescriptorConfig = DescriptorConfig()
    pool_cfg: PoolRegionConfig = PoolRegionConfig()
    pair_block: int = 256  # pairs per device batch in the distance stage
    progress: bool = True
    # gzip level of the streamed Distance matrix (level 1 keeps the
    # reference's gzip-chunked format at ~10x the write speed of level 9)
    dist_compression: int = 1
    device: str = "cuda"
    _dev: torch.device = field(init=False, repr=False)

    def __post_init__(self):
        self._dev = torch.device(self.device)
        if self._dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Workspace(device={self.device!r}): CUDA is not available; "
                f"pass device='cpu' to run the plain PyTorch path")

    def path(self, *parts: str) -> str:
        p = os.path.join(self.root, *parts)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    def _bar(self) -> Optional[TermProgress]:
        return TermProgress() if self.progress else None

    # -- stage 1: dataset conversion -------------------------------------

    def convert(self, patch_dir: str, ds: str,
                max_pairs: Optional[int] = None) -> str:
        """Brown patch dir -> dataset/{ds}.h5 (reference: 01-export.sh)."""
        out = self.path("dataset", f"{ds}.h5")
        convert_brown_patches(patch_dir, out, max_pairs=max_pairs,
                              progress=self.progress)
        return out

    # -- stage 2: pooling-region bank -------------------------------------

    def genpr(self) -> str:
        """Generate the candidate filter bank (reference: 02-genpoolregs.sh)."""
        out = self.path("filters.h5")
        if os.path.exists(out):
            st = _open_if_sound(out)
            if st is not None:
                with st:
                    if st.exists("PRFilters"):
                        return out
        rings, params, filters = build_filter_bank(self.pool_cfg)
        p = self.pool_cfg.patch_size
        with ArtifactStore(out, "w") as st:
            st.write("RingParams", rings)
            st.write("PRParams", params)
            st.write("PRFilters", filters.reshape(-1, p, p), chunk_rows=128)
            st.set_meta("pool_cfg", vars(self.pool_cfg))
        return out

    def load_filters(self) -> np.ndarray:
        with ArtifactStore(self.genpr(), "r") as st:
            f = st.read("PRFilters")
        return f.reshape(f.shape[0], -1)

    def load_pr_params(self) -> np.ndarray:
        with ArtifactStore(self.genpr(), "r") as st:
            return st.read("PRParams")

    def dist_path(self, ds: str) -> str:
        """Stage-3 output for ``ds``: the single-writer .h5 if present,
        else the multi-writer sharded store (whichever compdist produced
        under the process topology; readers are format-agnostic through
        data/shard_store.open_for_read)."""
        h5 = os.path.join(self.root, "distances", f"{ds}-dist.h5")
        if os.path.exists(h5):
            return h5
        shards = os.path.join(self.root, "distances", f"{ds}-dist.shards")
        if is_sharded_store(shards):
            return shards
        return h5   # canonical (an error surfaces at open)

    # -- stage 3: full ring-distance precompute ---------------------------

    def compdist(self, ds: str, sharded: Optional[bool] = None) -> str:
        """Per-pair ring distances (reference: 03-compdist.sh,
        src/comp-fulldists.cpp), streamed to a single-writer HDF5 file
        block by block.

        ``sharded`` (default: on iff the process group has more than one
        rank) switches to the multi-writer store (data/shard_store.py):
        every process computes and writes ITS OWN chunk-aligned row range
        of the distance matrix concurrently. Downstream readers are
        format-agnostic through open_for_read."""
        if sharded is None:
            sharded = process_count() > 1
        n_rings = self.pool_cfg.n_rings
        with ArtifactStore(self.path("dataset", f"{ds}.h5"), "r") as st:
            indices = st.read("Indices")
            patches = st.read("Patches")
        n_pairs = indices.shape[0]
        if sharded:
            return self._compdist_sharded(ds, indices, patches, n_pairs,
                                          n_rings)
        out = self.path("distances", f"{ds}-dist.h5")
        if os.path.exists(out):
            st = _open_if_sound(out)
            if st is not None:
                with st:
                    if (st.exists("Distance")
                            and st.shape("Distance") == (n_pairs, n_rings)
                            and st.get_meta("complete", False)):
                        return out

        bar = self._bar()
        with ArtifactStore(out, "w") as st:
            st.write("Label", pair_labels(indices).reshape(-1, 1))
            st.create("Distance", (n_pairs, n_rings), np.float32,
                      compression=self.dist_compression)
            self._dist_rows(st, indices, patches, 0, n_pairs, bar)
            if bar:
                bar.done()
            st.set_meta("complete", True)
        return out

    def _stage3_bank(self):
        """The bank on the device, prepared for the route stage 3 takes
        (``stage3_route``), and that route's name. Kernel A's bank is cast
        to bf16 or split into tf32 planes here, once per call, not once per
        block (``kernel_bank``)."""
        filters = torch.from_numpy(self.load_filters()).to(self._dev)
        route = stage3_route(self.desc_cfg.matmul_precision, filters.shape,
                             filters.device.type == "cuda")
        if route != "f32":
            filters = kernel_bank(filters, bf16=route == "kernel_A")
        return filters, route

    def _dist_rows(self, st, indices, patches, lo: int, hi: int, bar=None):
        """Compute + write distance rows [lo, hi) into ``st``, on the
        route ``_stage3_bank`` picks."""
        filters, route = self._stage3_bank()
        blk = self.pair_block
        for s in range(lo, hi, blk):
            e = min(s + blk, hi)
            p1 = torch.from_numpy(patches[indices[s:e, 0]]).to(self._dev)
            p2 = torch.from_numpy(patches[indices[s:e, 2]]).to(self._dev)
            pt1 = batch_patch_transform(p1, self.desc_cfg)
            pt2 = batch_patch_transform(p2, self.desc_cfg)
            d = stage3_distances(filters, route, pt1, pt2).cpu().numpy()
            if not np.all(np.isfinite(d)):
                raise FloatingPointError(
                    f"Distance contains NaN/Inf in rows [{s}, {e})"
                )  # reference: src/comp-fulldists.cpp:362-366
            st.write_rows("Distance", s, d)
            if bar:
                bar.update((e - lo) / max(hi - lo, 1))

    def _compdist_sharded(self, ds: str, indices, patches, n_pairs: int,
                          n_rings: int) -> str:
        """Multi-writer stage 3: each process owns a chunk-aligned row
        range (chunks of pair_block rows, so its blocks are the
        single-writer path's blocks) and writes it concurrently into the
        sharded store. Completion = every writer's done marker; the
        filesystem barrier waits for all of them."""
        out = self.path("distances", f"{ds}-dist.shards")
        pid, n_proc = process_index(), process_count()
        st = ShardedArrayStore(out)
        if (st.exists("Distance") and st.shape("Distance") ==
                (n_pairs, n_rings) and st.all_done(n_proc)):
            return out
        st.create("Label", (n_pairs, 1), np.int32, self.pair_block)
        st.create("Distance", (n_pairs, n_rings), np.float32,
                  self.pair_block)
        lo, hi = shard_rows(n_pairs, self.pair_block, pid, n_proc)
        labels = pair_labels(indices).reshape(-1, 1).astype(np.int32)
        st.write_rows("Label", lo, labels[lo:hi])
        self._dist_rows(st, indices, patches, lo, hi,
                        self._bar() if pid == 0 else None)
        st.mark_done(pid, {"rows": [int(lo), int(hi)]})
        # shared-filesystem contract: the stage's output is usable only
        # when every writer has landed
        deadline = time.time() + 600.0
        while not st.all_done(n_proc):
            if time.time() > deadline:
                missing = [w for w in range(n_proc) if not os.path.exists(
                    os.path.join(out, "_meta", f"done-{w}.json"))]
                raise TimeoutError(
                    f"compdist shards incomplete after 600s: {missing}")
            time.sleep(0.2)
        return out

    # -- shared loading for the learners ----------------------------------

    def _load_split(self, dist_path: str, train_frac: float, seed: int):
        """Split pos/neg, shuffle, 80/20 (reference: src/pr-learn.cpp:230-273).

        Rows stream from HDF5 in chunks and scatter into the four
        preallocated host split arrays; the same numpy shuffle as the JAX
        package, so both packages train on identical splits. ``dist_path``
        is an artifact or a sharded store (open_for_read)."""
        with open_for_read(dist_path) as st:
            labels = st.read("Label").reshape(-1)
            n_rows, n_feat = st.shape("Distance")
            pos_idx = np.flatnonzero(labels == 1)
            neg_idx = np.flatnonzero(labels == 0)
            rng = np.random.default_rng(seed)
            rng.shuffle(pos_idx)
            rng.shuffle(neg_idx)
            n_pos_trn = int(len(pos_idx) * train_frac)
            n_neg_trn = int(len(neg_idx) * train_frac)
            if min(n_pos_trn, n_neg_trn) == 0 or (
                    len(pos_idx) == n_pos_trn or len(neg_idx) == n_neg_trn):
                raise ValueError(
                    f"degenerate split for {dist_path}: "
                    f"{len(pos_idx)} positive / {len(neg_idx)} negative "
                    f"pairs at train_frac={train_frac} leave an empty train "
                    f"or validation side")
            split_idx = [pos_idx[:n_pos_trn], neg_idx[:n_neg_trn],
                         pos_idx[n_pos_trn:], neg_idx[n_neg_trn:]]
            arrs = [np.empty((len(ix), n_feat), np.float32)
                    for ix in split_idx]
            dest_split = np.empty(n_rows, np.int8)
            dest_row = np.empty(n_rows, np.int64)
            for si, ix in enumerate(split_idx):
                dest_split[ix] = si
                dest_row[ix] = np.arange(len(ix))
            for s, block in st.iter_rows("Distance"):
                ds_blk = dest_split[s:s + block.shape[0]]
                dr_blk = dest_row[s:s + block.shape[0]]
                for si in range(4):
                    m = ds_blk == si
                    if m.any():
                        arrs[si][dr_blk[m]] = block[m]
        return dict(pos_trn=arrs[0], neg_trn=arrs[1],
                    pos_val=arrs[2], neg_val=arrs[3])

    # -- stage 4: PR learning ---------------------------------------------

    def prlearn(self, ds: str, cfg: PRLearnConfig,
                dist_path: Optional[str] = None,
                _stop_after_logs: Optional[int] = None) -> str:
        """One PR RDA run -> pr-learn/{ds}-{mu}-{gamma}-pr.h5 with the
        improving-w history (reference: 04-prlearn.sh, src/pr-learn.cpp)."""
        dev = self._dev
        run = f"{ds}-{cfg.mu}-{cfg.gamma}-pr"
        out = self.path("pr-learn", f"{run}.h5")
        log_path = self.path("pr-learn", "logging", f"{run}.jsonl")
        marker = f"{cfg.n_iter}"
        resume = None
        if is_primary() and os.path.exists(out):
            st = _open_if_sound(out)
            if st is not None:
                with st:
                    if st.get_meta("done_iters") == marker:
                        return out
                    # mid-run snapshot: resume from it instead of restarting
                    resume = load_solver_state(st, PRState, device=dev)
                    resume_meta = st.get_meta("solver_state_meta") or {}
            if resume is None:
                remove_artifact(out)

        data = self._load_split(dist_path or self.dist_path(ds),
                                cfg.train_frac, cfg.seed)
        params = self.load_pr_params()
        check_device_budget({k: nbytes(v) for k, v in data.items()},
                            f"prlearn[{run}]", device=dev)
        splits = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        del data
        split_dt = torch.bfloat16 if cfg.split_dtype == "bf16" \
            else torch.float32
        pos_trn = splits["pos_trn"].to(split_dt)
        neg_trn = splits["neg_trn"].to(split_dt)
        pos_val, neg_val = splits["pos_val"], splits["neg_val"]

        mu = torch.tensor([cfg.mu], dtype=torch.float32, device=dev)
        gamma = torch.tensor([cfg.gamma], dtype=torch.float32, device=dev)
        steps_per_log = max(1, cfg.log_step // cfg.batch)
        n_logs = max(1, cfg.n_iter // (steps_per_log * cfg.batch))
        done_logs = 0
        obj_best = np.inf
        if resume is not None:
            state, gen = resume
            done_logs = int(resume_meta.get("completed_logs", 0))
            obj_best = float(resume_meta.get("obj_best", np.inf))
        else:
            state = pr_init(pos_trn.shape[1], 1, device=dev)
            gen = torch.Generator().manual_seed(cfg.seed)

        with MetricLogger(jsonl_path=log_path if is_primary() else None) \
                as log, writer_store(out, "a") as st:
            if resume is not None and resume_meta.get("w_rows") is not None:
                # drop any w row appended after the snapshot was taken
                st.truncate_rows("w", int(resume_meta["w_rows"]))
            n_w_rows = st.shape("w")[0] if st.exists("w") else 0
            t_train0 = time.perf_counter()
            for li in range(done_logs, n_logs):
                state = pr_train_chunk(pos_trn, neg_trn, mu, gamma, state,
                                       gen, batch=cfg.batch,
                                       n_steps=steps_per_log,
                                       sampling=cfg.sampling,
                                       precision=cfg.precision)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t_train = time.perf_counter() - t_train0
                t_val0 = time.perf_counter()
                loss, regul, obj, nnz = pr_validate(pos_val, neg_val, mu, state)
                obj0 = float(obj[0])
                if not np.isfinite(obj0):
                    # crash-fast on solver divergence (src/pr-learn.cpp:57)
                    raise FloatingPointError(
                        f"prlearn[{run}]: non-finite objective {obj0} at "
                        f"t={state.t} (loss={float(loss[0])}, "
                        f"regul={float(regul[0])})")
                t_val = time.perf_counter() - t_val0
                improved = obj0 < obj_best
                if improved:
                    obj_best = obj0
                log.pr_step(best=improved, t=state.t,
                            loss=float(loss[0]), regul=float(regul[0]),
                            obj=obj0, obj_best=obj_best, nnz=int(nnz[0]),
                            nnz_best=int(nnz[0]), ttime=t_train, vtime=t_val)
                if improved:
                    w_np = state.w[0].cpu().numpy()
                    stats = compute_pr_stats_splits(params, splits, w_np,
                                                    max_dim=cfg.max_dim)
                    saved = stats["dim"] <= cfg.max_dim
                    if saved:
                        st.append_row("w", w_np)
                        n_w_rows += 1
                    log.pr_stat(n_pr=stats["n_pr"], nz_dim=stats["nz_dim"],
                                dim=stats["dim"], max_dim=cfg.max_dim,
                                auc=stats["auc"] or 0.0,
                                fpr95=(stats["fpr95"]
                                       if stats["fpr95"] is not None
                                       else -1.0),
                                saved=saved)
                save_solver_state(st, state, gen,
                                  extra={"completed_logs": li + 1,
                                         "obj_best": obj_best,
                                         "w_rows": n_w_rows})
                if _stop_after_logs is not None and li + 1 >= _stop_after_logs:
                    raise RunInterrupted(f"stopped after log {li + 1}")
                t_train0 = time.perf_counter()
            st.set_meta("done_iters", marker)
            st.set_meta("config", vars(cfg))
        return out

    # -- stage 5/6: PR cross-dataset stats + ranking ----------------------

    def prstats(self, model_paths: Sequence[str],
                dist_paths: Dict[str, str],
                jsonl_path: Optional[str] = None) -> List[dict]:
        """Cross-evaluate every saved w of every model on every dataset
        (reference: 05-prstats.sh, src/pr-stats.cpp:196-252)."""
        params = self.load_pr_params()
        records = []
        with MetricLogger(jsonl_path=jsonl_path) as log:
            for ds, dpath in dist_paths.items():
                # the budget below is one matrix: drop the last dataset's
                # before the next is read and uploaded
                dists = None
                with ArtifactStore(dpath, "r") as st:
                    labels = st.read("Label").reshape(-1)
                    n_rows, n_feat = st.shape("Distance")
                    check_device_budget({"Distance": n_rows * n_feat * 4},
                                        f"prstats[{ds}]", device=self._dev)
                    dists = torch.from_numpy(st.read("Distance")).to(self._dev)
                labels_t = torch.from_numpy(labels).to(self._dev)
                for mpath in model_paths:
                    with ArtifactStore(mpath, "r") as st:
                        if not st.exists("w"):
                            # a sweep entry that never saved an iterate
                            # under the MaxDim gate
                            continue
                        hist = st.read("w")
                    all_stats = compute_pr_stats_rows(params, dists,
                                                      labels_t, hist)
                    for row, stats in enumerate(all_stats):
                        records.append(dict(model=mpath, row=row, dataset=ds,
                                            **stats))
                        log.model_stat(model=mpath, row=row, dataset=ds,
                                       dim=stats["dim"],
                                       fpr95=stats["fpr95"],
                                       auc=stats["auc"])
        return records

    @staticmethod
    def pr_rank(records: List[dict], top_k: int = 10) -> List[dict]:
        """Rank models by mean FPR95 over datasets, requiring presence on
        all datasets (reference: 06-pr-top.sh:20-46)."""
        datasets = sorted({r["dataset"] for r in records})
        by_model: Dict[Tuple[str, int], Dict[str, dict]] = {}
        for r in records:
            by_model.setdefault((r["model"], r["row"]), {})[r["dataset"]] = r
        ranked = []
        for (model, row), per_ds in by_model.items():
            if set(per_ds) != set(datasets):
                continue
            fprs = [per_ds[d]["fpr95"] for d in datasets]
            ranked.append(dict(
                model=model, row=row,
                mean_fpr95=float(np.mean(fprs)),
                per_dataset={d: per_ds[d]["fpr95"] for d in datasets},
                dim=per_ds[datasets[0]]["dim"],
            ))
        ranked.sort(key=lambda r: r["mean_fpr95"])
        return ranked[:top_k]

    # -- stage 7: unprojected difference vectors --------------------------

    def compunproj(self, ds: str, pr_ref: str) -> str:
        """Signed truncated-descriptor differences for the selected filters
        (reference: 07-compunproj.sh, src/comp-uprjdists.cpp)."""
        pr_path, row = parse_model_ref(pr_ref)
        with ArtifactStore(pr_path, "r") as st:
            hist = st.read("w")
        row = row if row >= 0 else hist.shape[0] - 1
        w = hist[row]
        pr_label = os.path.basename(pr_path).replace(".h5", "")
        out = self.path("distances", f"{ds}-{pr_label}#{row}-unproj.h5")
        sel = select_pr_filters(self.load_filters(), w)
        n_dim = sel.shape[0] * self.desc_cfg.n_angle_bins

        with ArtifactStore(self.path("dataset", f"{ds}.h5"), "r") as st:
            indices = st.read("Indices")
            patches = st.read("Patches")
        n_pairs = indices.shape[0]
        if os.path.exists(out):
            st = _open_if_sound(out)
            if st is not None:
                with st:
                    if (st.exists("Distance")
                            and st.shape("Distance") == (n_pairs, n_dim)
                            and st.get_meta("complete", False)):
                        return out

        sel_t = torch.from_numpy(sel.astype(np.float32)).to(self._dev)
        labels = pair_labels(indices)
        bar = self._bar()
        blk = self.pair_block
        with ArtifactStore(out, "w") as st:
            st.write("Label", labels.reshape(-1, 1))
            st.create("Distance", (n_pairs, n_dim), np.float32,
                      compression=self.dist_compression)
            for s in range(0, n_pairs, blk):
                e = min(s + blk, n_pairs)
                pt1 = batch_patch_transform(
                    torch.from_numpy(patches[indices[s:e, 0]]).to(self._dev),
                    self.desc_cfg)
                pt2 = batch_patch_transform(
                    torch.from_numpy(patches[indices[s:e, 2]]).to(self._dev),
                    self.desc_cfg)
                d = unprojected_diffs(sel_t, pt1, pt2,
                                      precision=self.desc_cfg.precision)
                d = d.cpu().numpy()
                if not np.all(np.isfinite(d)):
                    raise FloatingPointError(
                        f"unproj Distance NaN/Inf in rows [{s}, {e})"
                    )  # reference: src/comp-uprjdists.cpp:341-345
                st.write_rows("Distance", s, d)
                if bar:
                    bar.update(e / n_pairs)
            if bar:
                bar.done()
            st.set_meta("pr_ref", f"{pr_path}#{row}")
            st.set_meta("complete", True)
        return out

    # -- stage 8: PJ learning ---------------------------------------------

    def pjlearn(self, unproj_path: str, cfg: PJLearnConfig,
                run_label: Optional[str] = None,
                _stop_after_logs: Optional[int] = None) -> str:
        """One PJ RDA run -> pj-learn/{label}-{mu}-{gamma}-pj.h5 holding the
        best W, A (reference: 08-pjlearn.sh, src/pj-learn.cpp)."""
        if run_label is None:
            run_label = os.path.basename(unproj_path).replace("-unproj.h5", "")
        dev = self._dev
        run = f"{run_label}-{cfg.mu}-{cfg.gamma}-pj"
        out = self.path("pj-learn", f"{run}.h5")
        log_path = self.path("pj-learn", "logging", f"{run}.jsonl")
        marker = f"{cfg.n_iter}"
        resume = None
        resume_meta = {}
        if is_primary() and os.path.exists(out):
            st = _open_if_sound(out)
            if st is not None:
                with st:
                    if st.get_meta("done_iters") == marker:
                        return out
                    # mid-run snapshot: resume instead of restarting (the
                    # reference restarts a crashed pj-learn from zero,
                    # 08-pjlearn.sh:18-21)
                    resume = load_solver_state(st, pj_rda.PJState,
                                               device=dev)
                    resume_meta = st.get_meta("solver_state_meta") or {}
            if resume is None:
                remove_artifact(out)

        data = self._load_split(unproj_path, cfg.train_frac, cfg.seed)
        check_device_budget({k: nbytes(v) for k, v in data.items()},
                            f"pjlearn[{run}]", device=dev)
        splits = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        del data
        pos_trn, neg_trn = splits["pos_trn"], splits["neg_trn"]
        pos_val, neg_val = splits["pos_val"], splits["neg_val"]

        n_logs = max(1, cfg.n_iter // cfg.log_step)
        done_logs = 0
        obj_best, auc_best, fpr95_best = np.inf, 0.0, np.inf
        w_save = a_save = None
        if resume is not None:
            state, gen = resume
            done_logs = int(resume_meta.get("completed_logs", 0))
            obj_best = float(resume_meta.get("obj_best", np.inf))
            auc_best = float(resume_meta.get("auc_best", 0.0))
            fpr95_best = float(resume_meta.get("fpr95_best", np.inf))
        else:
            state = pj_rda.pj_init(pos_trn.shape[1], cfg.rank_cap, device=dev)
            gen = torch.Generator().manual_seed(cfg.seed)

        with MetricLogger(jsonl_path=log_path if is_primary() else None) \
                as log, writer_store(out, "a") as st:
            if resume is not None and st.exists("best_W"):
                w_save = st.read("best_W")
                a_save = st.read("best_A")
            t_train0 = time.perf_counter()
            for li in range(done_logs, n_logs):
                state = pj_rda.pj_train_chunk(
                    pos_trn, neg_trn, cfg.mu, cfg.gamma, state, gen,
                    batch=cfg.batch, n_steps=cfg.log_step,
                    eigh_mode=cfg.eigh_mode,
                    subspace_steps=cfg.subspace_steps, ns_iters=cfg.ns_iters)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t_train = time.perf_counter() - t_train0
                t_val0 = time.perf_counter()
                loss, regul, obj, rank = pj_rda.pj_validate(
                    pos_val, neg_val, cfg.mu, state)
                obj0 = float(obj)
                if not np.isfinite(obj0):
                    # crash-fast on solver divergence (src/pj-learn.cpp:57)
                    raise FloatingPointError(
                        f"pjlearn[{run}]: non-finite objective {obj0} at "
                        f"iter {state.t} (loss={float(loss)}, "
                        f"regul={float(regul)})")
                t_val = time.perf_counter() - t_val0
                improved = obj0 < obj_best
                if improved:
                    obj_best = obj0
                log.pj_step(best=improved, t=state.t, loss=float(loss),
                            regul=float(regul), obj=obj0, obj_best=obj_best,
                            rank=int(rank), rank_best=int(rank),
                            ttime=t_train, vtime=t_val)
                if improved:
                    # full-dataset stats + dual best criterion
                    # (reference: src/pj-learn.cpp:551-566)
                    w_np = state.w.cpu().numpy()
                    stats = compute_pj_stats_splits(splits, w_np)
                    saved = (auc_best <= stats["auc"]
                             and fpr95_best >= stats["fpr95"])
                    if saved:
                        auc_best = stats["auc"]
                        fpr95_best = stats["fpr95"]
                        w_save = w_np[np.any(w_np != 0.0, axis=1)]
                        a_save = state.a.cpu().numpy()
                        st.write("best_W", w_save)
                        st.write("best_A", a_save)
                    log.pj_stat(dim=stats["dim"], auc=stats["auc"],
                                auc_best=auc_best, fpr95=stats["fpr95"],
                                fpr95_best=fpr95_best, saved=saved)
                save_solver_state(st, state, gen,
                                  extra={"completed_logs": li + 1,
                                         "obj_best": obj_best,
                                         "auc_best": auc_best,
                                         "fpr95_best": fpr95_best})
                if _stop_after_logs is not None and li + 1 >= _stop_after_logs:
                    raise RunInterrupted(f"stopped after log {li + 1}")
                t_train0 = time.perf_counter()
            if w_save is None:
                w_np = state.w.cpu().numpy()
                w_save = w_np[np.any(w_np != 0.0, axis=1)]
                a_save = state.a.cpu().numpy()
            st.write("W", w_save)
            st.write("A", a_save)
            st.set_meta("done_iters", marker)
            st.set_meta("config", vars(cfg))
            st.set_meta("best", {"auc": float(auc_best),
                                 "fpr95": float(fpr95_best)})
        return out

    # -- stage 9/10: PJ model selection -----------------------------------

    def pjstats(self, model_paths: Sequence[str],
                unproj_paths: Dict[str, str],
                jsonl_path: Optional[str] = None) -> List[dict]:
        """Cross-evaluate every PJ model on every dataset's unprojected
        diff matrix (the train-on-A/test-on-B pass 09-pjstats.sh only
        approximates by scraping per-run train logs; mirrors prstats)."""
        records = []
        with MetricLogger(jsonl_path=jsonl_path) as log:
            for ds, upath in unproj_paths.items():
                diffs = None          # one matrix resident, as in prstats
                with ArtifactStore(upath, "r") as st:
                    labels = st.read("Label").reshape(-1)
                    n_rows, n_feat = st.shape("Distance")
                    check_device_budget({"Distance": n_rows * n_feat * 4},
                                        f"pjstats[{ds}]", device=self._dev)
                    diffs = torch.from_numpy(st.read("Distance")).to(self._dev)
                labels_t = torch.from_numpy(labels).to(self._dev)
                for mpath in model_paths:
                    with ArtifactStore(mpath, "r") as st:
                        w_proj = st.read("W")
                    if w_proj.shape[1] != n_feat:
                        continue  # different PR selection; not comparable
                    stats = compute_pj_stats(diffs, labels_t, w_proj)
                    records.append(dict(model=mpath, dataset=ds, **stats))
                    log.model_stat(model=mpath, row=0, dataset=ds,
                                   dim=stats["dim"], fpr95=stats["fpr95"],
                                   auc=stats["auc"])
        return records

    @staticmethod
    def pj_rank_cross(records: List[dict], max_dim: int,
                      top_k: int = 10) -> List[dict]:
        """Rank PJ models by mean FPR95 across datasets under a dim cap
        (the programmatic replacement of 10-pj-top.sh)."""
        datasets = sorted({r["dataset"] for r in records})
        by_model: Dict[str, Dict[str, dict]] = {}
        for r in records:
            by_model.setdefault(r["model"], {})[r["dataset"]] = r
        ranked = []
        for model, per_ds in by_model.items():
            if set(per_ds) != set(datasets):
                continue
            if any(p["dim"] > max_dim or p["dim"] == 0
                   for p in per_ds.values()):
                continue
            fprs = [per_ds[d]["fpr95"] for d in datasets]
            ranked.append(dict(
                model=model, mean_fpr95=float(np.mean(fprs)),
                per_dataset={d: per_ds[d]["fpr95"] for d in datasets},
                dim=max(p["dim"] for p in per_ds.values())))
        ranked.sort(key=lambda r: r["mean_fpr95"])
        return ranked[:top_k]

    @staticmethod
    def pj_rank(model_paths: Sequence[str], max_dim: int,
                top_k: int = 10) -> List[dict]:
        """Rank PJ runs by saved best FPR95 under a dim cap
        (reference: 09-pjstats.sh / 10-pj-top.sh log scraping)."""
        rows = []
        for p in model_paths:
            with ArtifactStore(p, "r") as st:
                best = st.get_meta("best", {})
                dim = st.shape("W")[0] if st.exists("W") else 0
            if dim and dim <= max_dim and best:
                rows.append(dict(model=p, dim=dim, **best))
        rows.sort(key=lambda r: r["fpr95"])
        return rows[:top_k]

    # -- stage 11: export --------------------------------------------------

    def export(self, pr_ref: str, pj_path: str, out_name: str) -> str:
        """Emit the OpenCV VGG header opencv/{out_name} (reference:
        11-opencv-export.sh, src/export-opencv.cpp)."""
        from .export import export_opencv

        return export_opencv(self.genpr(), pr_ref, pj_path,
                             self.path("opencv", out_name))

    # -- the whole workflow in one call ------------------------------------

    def run_full(self, datasets: Sequence[str],
                 pr_cfg: Optional[PRLearnConfig] = None,
                 pj_cfg: Optional[PJLearnConfig] = None,
                 pr_grid=None, pj_grid=None,
                 export_dims: Sequence[int] = (48, 64, 80, 120),
                 pj_datasets: Optional[Sequence[str]] = None,
                 pr_ckpt_every: int = 1,
                 pj_ckpt_every: int = 1) -> dict:
        """Stages 2-11 end-to-end with automatic model selection: PR sweep
        per dataset -> cross-dataset ranking -> unprojected diffs for the
        winner on every dataset -> PJ sweep on ``pj_datasets`` (default:
        all) -> cross-dataset PJ ranking (pjstats + pj_rank_cross) ->
        per-dim-cap export. Datasets must already be converted.

        Returns the selection results with per-stage wall-clock in
        ``stage_seconds``.
        """
        from ..parallel.sweep import run_pj_sweep, run_pr_sweep
        from ..utils.configs import PJSweepGrid, PRSweepGrid

        pr_cfg = pr_cfg or PRLearnConfig()
        # grids default to psd_ns; single runs (pjlearn) keep "exact"
        pj_cfg = pj_cfg or PJLearnConfig(eigh_mode="psd_ns")
        pr_grid = pr_grid or PRSweepGrid()
        pj_grid = pj_grid or PJSweepGrid()
        pj_datasets = list(pj_datasets or datasets)

        stage_seconds: Dict[str, float] = {}

        def timed(name, fn, *args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            stage_seconds[name] = round(
                stage_seconds.get(name, 0.0)
                + time.perf_counter() - t0, 3)
            return out

        timed("02_genpr", self.genpr)
        dist_paths = {ds: timed(f"03_compdist[{ds}]", self.compdist, ds)
                      for ds in datasets}

        models = []
        for ds in datasets:
            timed(f"04_prsweep[{ds}]", run_pr_sweep, self, ds,
                  pr_grid, pr_cfg, ckpt_every=pr_ckpt_every)
            models.extend(
                sorted(set(
                    os.path.join(self.root, "pr-learn", f)
                    for f in os.listdir(os.path.join(self.root, "pr-learn"))
                    if f.startswith(f"{ds}-") and f.endswith("-pr.h5"))))
        records = timed("05_prstats", self.prstats, models, dist_paths,
                        jsonl_path=self.path("pr-select.jsonl"))
        ranked = self.pr_rank(records)
        if not ranked:
            raise RuntimeError("no PR model ranked on all datasets")
        best_pr = ranked[0]
        pr_ref = f"{best_pr['model']}#{best_pr['row']}"

        unproj_paths = {ds: timed(f"07_compunproj[{ds}]",
                                  self.compunproj, ds, pr_ref)
                        for ds in datasets}
        pj_models = []
        for ds in pj_datasets:
            pj_models.extend(
                timed(f"08_pjsweep[{ds}]", run_pj_sweep, self,
                      unproj_paths[ds], pj_grid, pj_cfg,
                      ckpt_every=pj_ckpt_every))

        pj_records = timed(
            "09_pjstats", self.pjstats,
            [m["model"] for m in pj_models], unproj_paths,
            jsonl_path=self.path("pj-select.jsonl"))

        exports = {}
        pj_ranked = {}
        for dim in export_dims:
            ranked_dim = self.pj_rank_cross(pj_records, max_dim=dim)
            if not ranked_dim:
                continue
            winner = ranked_dim[0]
            pj_ranked[dim] = winner
            exports[dim] = timed(
                f"11_export[{dim}]", self.export,
                pr_ref, winner["model"], f"vgg_generated_{dim}.i")
        return dict(best_pr=best_pr, pr_ref=pr_ref, pj_models=pj_models,
                    pj_records=pj_records, pj_ranked=pj_ranked,
                    exports=exports, stage_seconds=stage_seconds)
