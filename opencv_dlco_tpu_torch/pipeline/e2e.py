"""Reference-scale end-to-end workflow run, and its stage-1 stand-in.

Port of ``opencv_dlco_tpu/pipeline/e2e.py``:

- ``generate_synthetic_dataset``: no Brown raw data ships with the repo,
  so datasets are drawn from the calibrated hard pair distribution
  (data/synthetic.HARD_PAIR_PARAMS) at the published shape (64x64 uint8,
  50% matched, the m50 index layout). On a CUDA workspace every full chunk
  is drawn on the card (``synth_patch_pairs_device``, a generator seeded
  ``seed * 1_000_003 + chunk start``); the tail chunk and CPU workspaces
  take the numpy route, independent substreams seeded (seed, chunk start)
  exactly as the JAX package's numpy route, so both packages write the
  same dataset for the same seed on the CPU.
- ``run_reference_scale``: the whole 11-stage chain at the reference's
  budgets in one call, every exported header round-tripped through
  ``parse_vgg_header`` and ``VGGDescriptor.from_header``, and a summary
  JSON with per-stage wall-clock. Entry point:
  ``python -m opencv_dlco_tpu_torch.cli e2e -w /path/ws``.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.store import ArtifactStore, remove_artifact
from ..data.synthetic import (HARD_PAIR_PARAMS, synth_patch_pairs,
                              synth_patch_pairs_device)
from ..utils.configs import (
    PJLearnConfig,
    PJSweepGrid,
    PRLearnConfig,
    PRSweepGrid,
)

#: Brown-published pair-set scale (m50_500000_500000_0.txt)
REFERENCE_N_PAIRS = 500_000

#: dataset-name -> generator seed; names deliberately not the Brown names,
#: the data is synthetic
DEFAULT_DATASETS = {"synlib": 11, "synnot": 22, "synyos": 33}


def generate_synthetic_dataset(ws, name: str, seed: int,
                               n_pairs: int = REFERENCE_N_PAIRS,
                               chunk: int = 4096) -> str:
    """dataset/{name}.h5 with Indices (N x 4 int32) + Patches (2N x 64 x 64
    uint8): pair i references patches (i, N+i); positives share a 3D-point
    id, negatives don't (the pair_labels contract). Idempotent: a complete
    dataset of this size is kept. A failure on the card raises: no chunk
    falls back to numpy."""
    out = ws.path("dataset", f"{name}.h5")
    if os.path.exists(out):
        try:
            with ArtifactStore(out, "r") as st:
                if (st.exists("Patches")
                        and st.shape("Patches") == (2 * n_pairs, 64, 64)
                        and st.get_meta("complete", False)):
                    return out
        except OSError:
            # a run killed mid-write leaves a truncated HDF5; regenerate
            pass
        remove_artifact(out)

    dev = torch.device(ws.device)
    indices = np.zeros((n_pairs, 4), np.int32)
    indices[:, 0] = np.arange(n_pairs)
    indices[:, 2] = np.arange(n_pairs) + n_pairs
    with ArtifactStore(out, "w") as st:
        st.create("Patches", (2 * n_pairs, 64, 64), np.uint8,
                  chunk_rows=chunk, compression=0)
        for s in range(0, n_pairs, chunk):
            e = min(s + chunk, n_pairs)
            if dev.type == "cuda" and e - s == chunk:
                g = torch.Generator(device=dev)
                g.manual_seed(seed * 1_000_003 + s)
                p1, p2, labels = synth_patch_pairs_device(
                    e - s, generator=g, device=dev, **HARD_PAIR_PARAMS)
            else:
                rng = np.random.default_rng((seed, s))
                p1, p2, labels = synth_patch_pairs(rng, n_pairs=e - s,
                                                   **HARD_PAIR_PARAMS)
            st.write_rows("Patches", s, p1)
            st.write_rows("Patches", n_pairs + s, p2)
            indices[s:e, 1] = indices[s:e, 0]
            indices[s:e, 3] = np.where(labels == 1, indices[s:e, 0],
                                       indices[s:e, 2])
        st.write("Indices", indices)
        st.set_meta("synthetic", True)
        st.set_meta("generator", {"seed": seed, "chunk": chunk,
                                  **HARD_PAIR_PARAMS})
        st.set_meta("complete", True)
    return out


def _roundtrip_header(path: str, device="cuda") -> dict:
    """Parse an exported header back and load it as a VGGDescriptor."""
    from ..models.vgg import VGGDescriptor
    from .export import parse_vgg_header

    with open(path) as fh:
        text = fh.read()
    mats = parse_vgg_header(text)
    desc = VGGDescriptor.from_header(text, device=device)
    if desc.sel_filters.shape[0] != mats["PR"].shape[0]:
        raise ValueError(f"{path}: descriptor holds "
                         f"{desc.sel_filters.shape[0]} filters, header "
                         f"{mats['PR'].shape[0]}")
    return {"path": path,
            "n_pr": int(mats["PR"].shape[0]),
            "dim": int(mats["PJ"].shape[0]),
            "pj_in": int(mats["PJ"].shape[1]),
            "ok": bool(mats["PJ"].shape[1] == mats["PR"].shape[0] * 8)}


def card_description(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them for this card, asked
    by its UUID (a card may be set below its maximum power and then runs
    slower under load); the name and "power limit not read" when
    nvidia-smi cannot answer."""
    uuid = torch.cuda.get_device_properties(dev).uuid
    try:
        line = subprocess.run(
            ["nvidia-smi", "-i", f"GPU-{uuid}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        line = ""
    return line or f"{torch.cuda.get_device_name(dev)}, power limit not read"


def run_reference_scale(root: str,
                        n_pairs: int = REFERENCE_N_PAIRS,
                        datasets: Optional[Dict[str, int]] = None,
                        pj_datasets: Optional[Sequence[str]] = None,
                        pr_iters: int = 50_000_000,
                        pj_iters: int = 50_000,
                        out_json: Optional[str] = None,
                        progress: bool = True,
                        pool_cfg=None,
                        pr_overrides: Optional[dict] = None,
                        pj_overrides: Optional[dict] = None,
                        pr_grid: Optional[PRSweepGrid] = None,
                        pj_grid: Optional[PJSweepGrid] = None,
                        export_dims: Sequence[int] = (48, 64, 80, 120),
                        device: str = "cuda") -> dict:
    """The whole reference workflow, reference budgets, one command.

    Budgets match the reference's published runs: 50M RDA samples per PR
    combo over the full 16x16 (mu, gamma) grid per dataset
    (04-prlearn.sh), 50k iterations per PJ combo over the 5x9 grid
    (08-pjlearn.sh), 48/64/80/120-D exports (11-opencv-export.sh). The PJ
    grid trains on the first dataset's unproj set and every PJ model is
    cross-evaluated on all datasets' unproj sets before the per-dim
    winner pick.
    """
    from .stages import Workspace

    datasets = dict(datasets or DEFAULT_DATASETS)
    names = list(datasets)
    pj_datasets = list(pj_datasets or names[:1])
    ws = Workspace(root, progress=progress, pair_block=8192, device=device,
                   **({"pool_cfg": pool_cfg} if pool_cfg else {}))

    t_start = time.time()
    stage_seconds: Dict[str, float] = {}
    for name, seed in datasets.items():
        t0 = time.perf_counter()
        generate_synthetic_dataset(ws, name, seed, n_pairs=n_pairs)
        stage_seconds[f"01_generate[{name}]"] = round(
            time.perf_counter() - t0, 3)

    # the tuned sweep path: bf16-resident splits through kernel B
    pr_kw = dict(n_iter=pr_iters, log_step=100_000, batch=2048,
                 max_dim=640, sampling="block_fused", split_dtype="bf16",
                 matmul_precision="default")
    pr_kw.update(pr_overrides or {})
    pr_cfg = PRLearnConfig(**pr_kw)
    pj_kw = dict(n_iter=pj_iters, log_step=500, batch=200,
                 eigh_mode="psd_ns")
    pj_kw.update(pj_overrides or {})
    pj_cfg = PJLearnConfig(**pj_kw)

    pr_grid = pr_grid or PRSweepGrid()
    pj_grid = pj_grid or PJSweepGrid()
    result = ws.run_full(
        names, pr_cfg=pr_cfg, pj_cfg=pj_cfg,
        pr_grid=pr_grid, pj_grid=pj_grid,
        export_dims=export_dims,
        pj_datasets=pj_datasets,
        # checkpoint every 10 log periods bounds sidecar IO
        pr_ckpt_every=10, pj_ckpt_every=10)
    stage_seconds.update(result["stage_seconds"])

    exports = {int(d): _roundtrip_header(p, device=device)
               for d, p in result["exports"].items()}
    dev = torch.device(device)
    summary = {
        "synthetic": True,
        "note": ("datasets are synthetic Brown-shaped patch sets "
                 "(no Brown raw data is mounted); FPR95 numbers are "
                 "NOT comparable to published Brown results"),
        "backend": dev.type,
        "device": card_description(dev) if dev.type == "cuda" else "cpu",
        "n_pairs": int(n_pairs),
        "n_rings": int(ws.pool_cfg.n_rings),
        "n_filters": int(ws.pool_cfg.n_filters),
        "datasets": names,
        "pj_datasets": pj_datasets,
        "pr_grid_combos": len(pr_grid.combos()),
        "pj_grid_combos": len(pj_grid.combos()),
        "pr_iters_per_combo": int(pr_iters),
        "pj_iters_per_combo": int(pj_iters),
        "best_pr": {k: result["best_pr"][k]
                    for k in ("mean_fpr95", "per_dataset", "dim", "row")},
        "pr_ref": os.path.basename(result["pr_ref"]),
        "n_pj_models": len(result["pj_models"]),
        "pj_winners": {
            int(d): {"model": os.path.basename(w["model"]),
                     "mean_fpr95": w["mean_fpr95"],
                     "per_dataset": w["per_dataset"],
                     "dim": w["dim"]}
            for d, w in result["pj_ranked"].items()},
        "exports": exports,
        "stage_seconds": stage_seconds,
        "total_wall_seconds": round(time.time() - t_start, 1),
    }
    out_json = out_json or os.path.join(root, "E2E_FULL.json")
    with open(out_json, "w") as fh:
        json.dump(summary, fh, indent=1, sort_keys=True)
    return summary
