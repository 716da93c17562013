"""Stages 1-6 of the DLCO workflow on one CUDA device.

Port of the PR half of ``opencv_dlco_tpu/pipeline/stages.py``: every stage
is a method over a Workspace directory with the reference's artifact layout
and resume contract (a stage is skipped iff its output artifact is
complete), structured JSONL metrics, and device-batched compute.

Workspace layout (mirrors reference workspace/, the same files the JAX
package writes):
    dataset/{ds}.h5                  Indices + Patches        (stage 1)
    filters.h5                       Ring/PR params + filters (stage 2)
    distances/{ds}-dist.h5           Label + Distance         (stage 3)
    pr-learn/{run}.h5 + logging/     w histories + metrics    (stage 4)
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.brown import convert_brown_patches, pair_labels
from ..data.store import ArtifactStore, remove_artifact, writer_store
from ..models.pr_rda import PRState, pr_init, pr_train_chunk, pr_validate
from ..models.select import compute_pr_stats_rows, compute_pr_stats_splits
from ..ops.pair_distance import ring_distances
from ..ops.pair_distance_fused import TF, TK, ring_distances_fused
from ..ops.patch_transform import batch_patch_transform
from ..ops.pool_regions import build_filter_bank
from ..parallel.distributed import is_primary
from ..utils.checkpoint import is_lock_error, open_lock_retry
from ..utils.configs import DescriptorConfig, PoolRegionConfig, PRLearnConfig
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
        """Stage-3 output for ``ds``."""
        return os.path.join(self.root, "distances", f"{ds}-dist.h5")

    # -- stage 3: full ring-distance precompute ---------------------------

    def compdist(self, ds: str) -> str:
        """Per-pair ring distances (reference: 03-compdist.sh,
        src/comp-fulldists.cpp), streamed to a single-writer HDF5 file
        block by block."""
        n_rings = self.pool_cfg.n_rings
        with ArtifactStore(self.path("dataset", f"{ds}.h5"), "r") as st:
            indices = st.read("Indices")
            patches = st.read("Patches")
        n_pairs = indices.shape[0]
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

    def _dist_rows(self, st, indices, patches, lo: int, hi: int, bar=None):
        """Compute + write distance rows [lo, hi) into ``st``.

        precision "highest" runs the f32 route (ops/pair_distance.py); any
        other precision takes kernel A (bf16 inputs, f32 accumulation) when
        the bank's shape fits its tiles. The bank is cast to bf16 once per
        call, not once per block."""
        filters = torch.from_numpy(self.load_filters()).to(self._dev)
        nf, npix = filters.shape
        use_fused = (self.desc_cfg.matmul_precision != "highest"
                     and nf % TF == 0 and npix % TK == 0)
        if use_fused:
            filters = filters.to(torch.bfloat16)
        blk = self.pair_block
        for s in range(lo, hi, blk):
            e = min(s + blk, hi)
            p1 = torch.from_numpy(patches[indices[s:e, 0]]).to(self._dev)
            p2 = torch.from_numpy(patches[indices[s:e, 2]]).to(self._dev)
            pt1 = batch_patch_transform(p1, self.desc_cfg)
            pt2 = batch_patch_transform(p2, self.desc_cfg)
            if use_fused:
                d = ring_distances_fused(filters, pt1, pt2, bf16=True)
            else:
                d = ring_distances(filters, pt1, pt2)
            d = d.cpu().numpy()
            if not np.all(np.isfinite(d)):
                raise FloatingPointError(
                    f"Distance contains NaN/Inf in rows [{s}, {e})"
                )  # reference: src/comp-fulldists.cpp:362-366
            st.write_rows("Distance", s, d)
            if bar:
                bar.update((e - lo) / max(hi - lo, 1))

    # -- shared loading for the learners ----------------------------------

    def _load_split(self, dist_path: str, train_frac: float, seed: int):
        """Split pos/neg, shuffle, 80/20 (reference: src/pr-learn.cpp:230-273).

        Rows stream from HDF5 in chunks and scatter into the four
        preallocated host split arrays; the same numpy shuffle as the JAX
        package, so both packages train on identical splits."""
        with ArtifactStore(dist_path, "r") as st:
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
        from ..utils.checkpoint import (RunInterrupted, load_solver_state,
                                        save_solver_state)

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
