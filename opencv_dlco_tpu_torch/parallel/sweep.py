"""Hyperparameter sweep engines: each grid trains as one loop.

Port of ``opencv_dlco_tpu/parallel/sweep.py`` (``run_pr_sweep``,
``run_pj_sweep``). The reference's sweeps are sequential
runs driven by bash (workspace/04-prlearn.sh, 08-pjlearn.sh); here the
whole (mu, gamma) grid is the leading S axis of the batched solvers
(models/pr_rda.py, models/pj_rda.py). PR entries share each step's sampled
block, so the per-sample work is (B, F) x (F, S) products — through kernel B
for the 16 x 16 grid; the 5 x 9 PJ grid's eigendecompositions and
Newton-Schulz products run batched over S.

Per-entry best iterates are tracked on the device and written to the
per-run artifacts exactly like single runs. The stacked solver state, the
generator and the per-combo positions checkpoint into a sidecar
``*-sweep-ckpt.h5`` every ``ckpt_every`` log periods, and an interrupted
sweep resumes from it with identical final artifacts.

Multi-process runs (a process group of more than one rank) run the grid
on every rank, write artifacts from the primary only, and switch the
sidecar to utils/checkpoint.ShardedSweepCheckpoint: every process writes
its own combo-range shard of the stacked state to its own file
(double-buffered slots; no primary-writer IO funnel) and every process
resumes from the assembled newest common wave.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..data.store import ArtifactStore, remove_artifact, writer_store
from ..models.pj_rda import (
    PJState,
    pj_init_batch,
    pj_train_chunk_batch,
    pj_validate,
)
from ..models.pr_rda import PRState, pr_init, pr_train_chunk, pr_validate
from ..models.select import compute_pj_stats_splits, pr_geometry
from ..utils.checkpoint import (
    RunInterrupted,
    ShardedSweepCheckpoint,
    load_solver_state,
    save_solver_state,
)
from ..utils.configs import (
    PJLearnConfig,
    PJSweepGrid,
    PRLearnConfig,
    PRSweepGrid,
)
from ..utils.logs import MetricLogger
from ..utils.memory import check_device_budget, nbytes
from .distributed import is_primary, process_count, process_index

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


def _completed_sweep_results(ws, subdir: str, runs, combos, n_iter: int,
                             sidecar: str):
    """Stage-level idempotence (04-prlearn.sh:17-22, 08-pjlearn.sh:18-21):
    when every combo artifact carries the done marker for this budget and
    no resume sidecar is pending, return per-combo summaries instead of
    retraining; any mismatch -> None. Multi-process runs always train
    (their ranks must run the same program)."""
    if os.path.exists(sidecar) or process_count() > 1:
        return None
    results = []
    for run, c in zip(runs, combos):
        path = ws.path(subdir, f"{run}.h5")
        if not os.path.exists(path):
            return None
        try:
            with ArtifactStore(path, "r") as st:
                if st.get_meta("done_iters") != f"{n_iter}":
                    return None
                rec = dict(mu=c[0], gamma=c[1], model=path, obj=np.inf, nnz=0)
                best = st.get_meta("best") or {}
                rec.update({k: best[k] for k in ("auc", "fpr95")
                            if k in best})
                if st.exists("w"):
                    rec["nnz"] = int(np.sum(st.read("w")[-1] > 0.0))
                if st.exists("W"):
                    w_np = st.read("W")
                    rec["dim"] = int(np.sum(np.any(w_np != 0.0, axis=1)))
                results.append(rec)
        except OSError:
            return None
    return results


def _sharded_sidecar(ws, subdir: str, label: str, s: int):
    """The per-process sidecar of a multi-process sweep (None for one
    process, which keeps the one-file sidecar)."""
    if process_count() <= 1:
        return None
    return ShardedSweepCheckpoint(ws.path(subdir, f"{label}-sweep-ckpt"),
                                  process_index(), process_count(), s)


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
        ws, "pr-learn", [f"{ds}-{c[0]}-{c[1]}-pr" for c in combos], combos,
        base.n_iter, sidecar=ckpt_path)
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
    geometry = pr_geometry(ws.load_pr_params())

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
    sck = _sharded_sidecar(ws, "pr-learn", ds, s)
    if sck is not None:
        loaded = sck.load(PRState, signature, device=dev)
        if loaded is not None:
            st_l, gen_l, arrs, done_logs = loaded
            resume = (st_l, gen_l)
            best_obj = torch.from_numpy(arrs["best_obj"]).to(dev)
            best_w = torch.from_numpy(arrs["best_w"]).to(dev)
            row_counts = np.asarray(arrs["row_counts"])
    elif primary and os.path.exists(ckpt_path):
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
            arrays = {"best_obj": best_obj.cpu().numpy(),
                      "best_w": best_w.cpu().numpy(),
                      "row_counts": row_counts}
            if sck is not None:
                sck.save(state, gen, arrays, signature, li + 1)
                return
            with writer_store(ckpt_path, "a") as ck:
                save_solver_state(ck, state, gen,
                                  extra={"completed_logs": li + 1},
                                  compression=0)
                for name, arr in arrays.items():
                    ck.write(name, arr, compression=0)
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
                _, dim, _ = geometry(w_np)
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
        if sck is not None:
            sck.cleanup()
        elif primary and os.path.exists(ckpt_path):
            remove_artifact(ckpt_path)
        return results
    finally:
        for st in stores.values():
            st.close()
        log.close()


def run_pj_sweep(ws, unproj_path: str, grid: PJSweepGrid,
                 base: PJLearnConfig, run_label: Optional[str] = None,
                 _stop_after_logs: Optional[int] = None,
                 ckpt_every: int = 1) -> List[dict]:
    """Train the PJ grid on one unprojected diff set as one batched loop.

    All S = |grid| solver states train together over the resident dataset,
    each on its own sampled rows (models/pj_rda.pj_train_chunk_batch).
    Objective-best iterates are tracked on the device; full-dataset
    FPR95/AUC stats are evaluated once per entry at the end, and each entry
    writes the pj-learn/{label}-{mu}-{gamma}-pj.h5 artifact
    Workspace.pjlearn would. Returns per-combo summaries sorted by FPR95.
    """
    dev = ws.device
    combos = grid.combos()
    s = len(combos)
    mus = torch.tensor([c[0] for c in combos], dtype=torch.float32, device=dev)
    gammas = torch.tensor([c[1] for c in combos], dtype=torch.float32,
                          device=dev)
    if run_label is None:
        run_label = os.path.basename(unproj_path).replace("-unproj.h5", "")
    ckpt_path = ws.path("pj-learn", f"{run_label}-sweep-ckpt.h5")
    done = _completed_sweep_results(
        ws, "pj-learn", [f"{run_label}-{m}-{g}-pj" for m, g in combos],
        combos, base.n_iter, sidecar=ckpt_path)
    if done is not None:
        done.sort(key=lambda r: r.get("fpr95", np.inf))
        return done

    data = ws._load_split(unproj_path, base.train_frac, base.seed)
    n_feat = data["pos_trn"].shape[1]
    rank_cap = base.rank_cap or n_feat
    check_device_budget(
        {**{k: nbytes(v) for k, v in data.items()},
         "sweep_state": 4 * s * n_feat * n_feat * 4,
         "best_iterates": 2 * s * n_feat * n_feat * 4},
        f"pj_sweep[{run_label}]", device=dev)
    splits = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    del data
    pos_trn, neg_trn = splits["pos_trn"], splits["neg_trn"]
    pos_val, neg_val = splits["pos_val"], splits["neg_val"]

    n_logs = max(1, base.n_iter // base.log_step)
    signature = _sweep_signature(combos, base, n_feat,
                                 {"eigh_mode": base.eigh_mode,
                                  "rank_cap": rank_cap})
    primary = is_primary()
    done_logs = 0
    resume = None
    sck = _sharded_sidecar(ws, "pj-learn", run_label, s)
    if sck is not None:
        loaded = sck.load(PJState, signature, device=dev)
        if loaded is not None:
            st_l, gen_l, arrs, done_logs = loaded
            resume = (st_l, gen_l)
            best_obj = torch.from_numpy(arrs["best_obj"]).to(dev)
            best_w = torch.from_numpy(arrs["best_w"]).to(dev)
            best_a = torch.from_numpy(arrs["best_a"]).to(dev)
    elif primary and os.path.exists(ckpt_path):
        with ArtifactStore(ckpt_path, "r") as ck:
            if ck.get_meta("signature") == signature:
                resume = load_solver_state(ck, PJState, device=dev)
                meta = ck.get_meta("solver_state_meta") or {}
                done_logs = int(meta.get("completed_logs", 0))
                best_obj = torch.from_numpy(ck.read("best_obj")).to(dev)
                best_w = torch.from_numpy(ck.read("best_w")).to(dev)
                best_a = torch.from_numpy(ck.read("best_a")).to(dev)
        if resume is None:
            remove_artifact(ckpt_path)

    if resume is not None:
        states, gen = resume
    else:
        states = pj_init_batch(n_feat, s, base.rank_cap, device=dev)
        gen = torch.Generator().manual_seed(base.seed)
        best_obj = torch.full((s,), float("inf"), dtype=torch.float32,
                              device=dev)
        best_w = torch.zeros((s, rank_cap, n_feat), dtype=torch.float32,
                             device=dev)
        best_a = torch.zeros((s, n_feat, n_feat), dtype=torch.float32,
                             device=dev)

    def save_ckpt(li):
        arrays = {"best_obj": best_obj.cpu().numpy(),
                  "best_w": best_w.cpu().numpy(),
                  "best_a": best_a.cpu().numpy()}
        if sck is not None:
            sck.save(states, gen, arrays, signature, li + 1)
            return
        with writer_store(ckpt_path, "a") as ck:
            save_solver_state(ck, states, gen,
                              extra={"completed_logs": li + 1},
                              compression=0)
            for name, arr in arrays.items():
                ck.write(name, arr, compression=0)
            ck.set_meta("signature", signature)

    log = MetricLogger(jsonl_path=ws.path("pj-learn", "logging",
                                          f"{run_label}-sweep.jsonl")
                       if primary else None)
    t0 = time.perf_counter()
    try:
        for li in range(done_logs, n_logs):
            states = pj_train_chunk_batch(
                pos_trn, neg_trn, mus, gammas, states, gen, batch=base.batch,
                n_steps=base.log_step, eigh_mode=base.eigh_mode,
                subspace_steps=base.subspace_steps, ns_iters=base.ns_iters)
            loss, regul, obj, rank = pj_validate(pos_val, neg_val, mus,
                                                 states)
            _check_finite(obj, f"pj_sweep[{run_label}]", states.t)
            improved = obj < best_obj
            best_obj = torch.where(improved, obj, best_obj)
            best_w = torch.where(improved[:, None, None], states.w, best_w)
            best_a = torch.where(improved[:, None, None], states.a, best_a)
            med = float(np.median(obj.cpu().numpy()))
            log.record(
                "pj_sweep_step",
                f"PJSweepStep: iter {states.t} x {s} combos  "
                f"medObj: {med:.6f}  t: {time.perf_counter() - t0:.1f}s",
                t=states.t, med_obj=med)
            if (li + 1) % ckpt_every == 0 or li + 1 == n_logs:
                save_ckpt(li)
            if _stop_after_logs is not None and li + 1 >= _stop_after_logs:
                if (li + 1) % ckpt_every != 0:
                    save_ckpt(li)
                raise SweepInterrupted(f"stopped after log {li + 1}")
        results = []
        best_w_np = best_w.cpu().numpy()
        best_a_np = best_a.cpu().numpy()
        for si, (mu, gamma) in enumerate(combos):
            w_np = best_w_np[si]
            stats = compute_pj_stats_splits(splits, w_np)
            out = ws.path("pj-learn", f"{run_label}-{mu}-{gamma}-pj.h5")
            with writer_store(out, "w") as st:
                st.write("W", w_np[np.any(w_np != 0.0, axis=1)])
                st.write("A", best_a_np[si])
                st.set_meta("done_iters", f"{base.n_iter}")
                st.set_meta("config", {"mu": mu, "gamma": gamma,
                                       "sweep": True})
                st.set_meta("best", {"auc": stats["auc"],
                                     "fpr95": stats["fpr95"]})
            results.append(dict(mu=mu, gamma=gamma, model=out,
                                dim=stats["dim"], auc=stats["auc"],
                                fpr95=stats["fpr95"]))
        results.sort(key=lambda r: r.get("fpr95", np.inf))
        if sck is not None:
            sck.cleanup()
        elif primary and os.path.exists(ckpt_path):
            remove_artifact(ckpt_path)
        return results
    finally:
        log.close()
