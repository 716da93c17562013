"""PR hyperparameter sweep engine: the grid trains as one loop.

Port of ``opencv_dlco_tpu/parallel/sweep.py::run_pr_sweep`` on a single
device. The reference's PR sweep is 768 sequential runs driven by bash
(workspace/04-prlearn.sh); here the whole (mu, gamma) grid is the leading S
axis of the batched solver (models/pr_rda.py), so every sweep entry shares
each step's sampled block and the per-sample work is (B, F) x (F, S)
products — through kernel B for the 16 x 16 grid.

Per-entry best iterates are tracked on the device and appended to the
per-run artifact history exactly like single runs. The stacked solver
state, the generator and the per-combo append positions checkpoint into a
sidecar ``*-sweep-ckpt.h5`` every ``ckpt_every`` log periods, and an
interrupted sweep resumes from it with identical final artifacts.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..data.store import ArtifactStore, remove_artifact, writer_store
from ..models.pr_rda import PRState, pr_init, pr_train_chunk, pr_validate
from ..models.select import selected_pr_geometry
from ..utils.checkpoint import (
    RunInterrupted,
    load_solver_state,
    save_solver_state,
)
from ..utils.configs import PRLearnConfig, PRSweepGrid
from ..utils.logs import MetricLogger
from ..utils.memory import check_device_budget, nbytes
from .distributed import is_primary

SweepInterrupted = RunInterrupted


def _track_best(obj, best_obj, w, best_w):
    """Per-entry best-iterate tracking, on the device."""
    improved = obj < best_obj
    best_obj = torch.where(improved, obj, best_obj)
    best_w = torch.where(improved[:, None], w, best_w)
    return improved, best_obj, best_w


def _check_finite(obj, what, t):
    """Crash-fast on a diverged sweep entry (src/pr-learn.cpp:57)."""
    bad = np.flatnonzero(~np.isfinite(obj.cpu().numpy()))
    if bad.size:
        raise FloatingPointError(
            f"{what}: non-finite objective for sweep entries {bad.tolist()} "
            f"at t={t}")


def _sweep_signature(combos, base, n_feat, extra=None):
    return {
        "combos": [list(c) for c in combos],
        "n_iter": base.n_iter, "batch": base.batch,
        "log_step": base.log_step, "seed": base.seed,
        "train_frac": base.train_frac, "n_feat": int(n_feat),
        **(extra or {}),
    }


def _completed_sweep_results(ws, runs, combos, n_iter: int, sidecar: str):
    """Stage-level idempotence (04-prlearn.sh:17-22): when every combo
    artifact carries the done marker for this budget and no resume sidecar
    is pending, return per-combo summaries instead of retraining; any
    mismatch -> None."""
    if os.path.exists(sidecar):
        return None
    results = []
    for run, c in zip(runs, combos):
        path = ws.path("pr-learn", f"{run}.h5")
        if not os.path.exists(path):
            return None
        try:
            with ArtifactStore(path, "r") as st:
                if st.get_meta("done_iters") != f"{n_iter}":
                    return None
                rec = dict(mu=c[0], gamma=c[1], model=path, obj=np.inf, nnz=0)
                if st.exists("w"):
                    rec["nnz"] = int(np.sum(st.read("w")[-1] > 0.0))
                results.append(rec)
        except OSError:
            return None
    return results


def run_pr_sweep(ws, ds: str, grid: PRSweepGrid, base: PRLearnConfig,
                 dist_path: Optional[str] = None,
                 _stop_after_logs: Optional[int] = None,
                 ckpt_every: int = 1) -> List[dict]:
    """Train the full (mu, gamma) grid for one dataset in a single loop.

    Writes one pr-learn/{ds}-{mu}-{gamma}-pr.h5 per combo (best-w history,
    same layout as Workspace.prlearn) and returns per-combo summaries
    sorted by final validation objective. ``ckpt_every``: sidecar cadence
    in log periods.
    """
    dev = ws.device
    combos = grid.combos()
    s = len(combos)
    mus = torch.tensor([c[0] for c in combos], dtype=torch.float32, device=dev)
    gammas = torch.tensor([c[1] for c in combos], dtype=torch.float32,
                          device=dev)
    ckpt_path = ws.path("pr-learn", f"{ds}-sweep-ckpt.h5")

    done = _completed_sweep_results(
        ws, [f"{ds}-{c[0]}-{c[1]}-pr" for c in combos], combos, base.n_iter,
        sidecar=ckpt_path)
    if done is not None:
        return done

    data = ws._load_split(dist_path or ws.dist_path(ds), base.train_frac,
                          base.seed)
    # budget at f32 size: a safe overestimate when the splits go to bf16
    check_device_budget({k: nbytes(v) for k, v in data.items()},
                        f"pr_sweep[{ds}]", device=dev)
    split_dt = torch.bfloat16 if base.split_dtype == "bf16" else torch.float32
    pos_trn = torch.from_numpy(data["pos_trn"]).to(dev).to(split_dt)
    neg_trn = torch.from_numpy(data["neg_trn"]).to(dev).to(split_dt)
    pos_val = torch.from_numpy(data["pos_val"]).to(dev)
    neg_val = torch.from_numpy(data["neg_val"]).to(dev)
    del data
    params = ws.load_pr_params()

    n_feat = pos_trn.shape[1]
    steps_per_log = max(1, base.log_step // base.batch)
    n_logs = max(1, base.n_iter // (steps_per_log * base.batch))
    signature = _sweep_signature(combos, base, n_feat,
                                 {"sampling": base.sampling,
                                  "matmul_precision": base.matmul_precision,
                                  "split_dtype": base.split_dtype})

    primary = is_primary()
    done_logs = 0
    resume = None
    if primary and os.path.exists(ckpt_path):
        with ArtifactStore(ckpt_path, "r") as ck:
            if ck.get_meta("signature") == signature:
                resume = load_solver_state(ck, PRState, device=dev)
                meta = ck.get_meta("solver_state_meta") or {}
                done_logs = int(meta.get("completed_logs", 0))
                best_obj = torch.from_numpy(ck.read("best_obj")).to(dev)
                best_w = torch.from_numpy(ck.read("best_w")).to(dev)
                row_counts = ck.read("row_counts")
        if resume is None:
            remove_artifact(ckpt_path)

    if resume is not None:
        state, gen = resume
    else:
        state = pr_init(n_feat, s, device=dev)
        gen = torch.Generator().manual_seed(base.seed)
        best_obj = torch.full((s,), float("inf"), dtype=torch.float32,
                              device=dev)
        best_w = torch.zeros((s, n_feat), dtype=torch.float32, device=dev)
        row_counts = np.zeros((s,), np.int64)

    log = MetricLogger(jsonl_path=ws.path("pr-learn", "logging",
                                          f"{ds}-sweep.jsonl")
                       if primary else None)
    stores = {}
    try:
        for si, c in enumerate(combos):
            path = ws.path("pr-learn", f"{ds}-{c[0]}-{c[1]}-pr.h5")
            if primary and resume is None and os.path.exists(path):
                remove_artifact(path)
            stores[c] = writer_store(path, "a")
            if resume is not None:
                # drop any rows appended after the checkpoint was taken
                stores[c].truncate_rows("w", int(row_counts[si]))

        def save_ckpt(li):
            with writer_store(ckpt_path, "a") as ck:
                save_solver_state(ck, state, gen,
                                  extra={"completed_logs": li + 1},
                                  compression=0)
                ck.write("best_obj", best_obj.cpu().numpy(), compression=0)
                ck.write("best_w", best_w.cpu().numpy(), compression=0)
                ck.write("row_counts", row_counts, compression=0)
                ck.set_meta("signature", signature)

        t0 = time.perf_counter()
        for li in range(done_logs, n_logs):
            state = pr_train_chunk(pos_trn, neg_trn, mus, gammas, state, gen,
                                   batch=base.batch, n_steps=steps_per_log,
                                   sampling=base.sampling,
                                   precision=base.precision)
            loss, regul, obj, nnz = pr_validate(pos_val, neg_val, mus, state)
            _check_finite(obj, f"pr_sweep[{ds}]", state.t)
            improved, best_obj, best_w = _track_best(obj, best_obj, state.w,
                                                     best_w)
            imp_idx = np.flatnonzero(improved.cpu().numpy())
            w_host = state.w[torch.from_numpy(imp_idx).to(dev)].cpu().numpy() \
                if imp_idx.size else None
            for j, si in enumerate(imp_idx):
                w_np = w_host[j]
                _, dim, _ = selected_pr_geometry(params, w_np)
                if dim <= base.max_dim:
                    stores[combos[si]].append_row("w", w_np)
                    row_counts[si] += 1
            med = float(np.median(obj.cpu().numpy()))
            log.record(
                "pr_sweep_step",
                f"SweepStep: {state.t} samples x {s} combos  "
                f"improved: {imp_idx.size}  medObj: {med:.6f}  "
                f"t: {time.perf_counter() - t0:.1f}s",
                t=state.t, improved=int(imp_idx.size), med_obj=med)
            if (li + 1) % ckpt_every == 0 or li + 1 == n_logs:
                save_ckpt(li)
            if _stop_after_logs is not None and li + 1 >= _stop_after_logs:
                if (li + 1) % ckpt_every != 0:
                    save_ckpt(li)
                raise SweepInterrupted(f"stopped after log {li + 1}")
        results = []
        obj_np = best_obj.cpu().numpy()
        nnz_np = (nnz if done_logs < n_logs
                  else (best_w > 0.0).sum(dim=1)).cpu().numpy()
        for si, c in enumerate(combos):
            stores[c].set_meta("done_iters", f"{base.n_iter}")
            stores[c].set_meta("config", {"mu": c[0], "gamma": c[1],
                                          "sweep": True})
            results.append(dict(mu=c[0], gamma=c[1], obj=float(obj_np[si]),
                                nnz=int(nnz_np[si]), model=stores[c].path))
        results.sort(key=lambda r: r["obj"])
        if primary and os.path.exists(ckpt_path):
            remove_artifact(ckpt_path)
        return results
    finally:
        for st in stores.values():
            st.close()
        log.close()
