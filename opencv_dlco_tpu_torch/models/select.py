"""Model selection and statistics for learned PR models.

Port of ``opencv_dlco_tpu/models/select.py`` (reference:
src/misc.cpp:78-169 SelectPRFilters, :171-264 ComputePRStats, :266-333
ComputePJStats): filter selection and geometry are host numpy; the "apply
model" products (w . Dists^T, colsum((W diffs^T)^2)) and the ROC sweeps run
on the tensors' device in f32 (TF32 off).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..ops.roc import roc_stats


def select_pr_filters(filters: np.ndarray, w: np.ndarray,
                      n_symmetries: int = 8) -> np.ndarray:
    """Unique, lexicographically sorted filters selected by nonzero w
    (MATLAB unique(...,'rows') semantics, reference: src/misc.cpp:78-169)."""
    w = np.asarray(w).reshape(-1)
    filters = np.asarray(filters)
    if w.shape[0] * n_symmetries != filters.shape[0]:
        raise ValueError(f"w rings {w.shape[0]} x {n_symmetries} != "
                         f"filters {filters.shape[0]}")
    mask = np.repeat(w > 0.0, n_symmetries)
    mask &= np.any(filters != 0.0, axis=1)
    return np.unique(filters[mask], axis=0)


@functools.lru_cache(maxsize=4)
def _param_groups(raw: bytes, shape: Tuple[int, ...], dtype: str):
    """(nonzero-row mask, equal-row group id) of a PRParams bank, computed
    once per bank: the row sort behind the dedup runs once, not once per
    model row (one sweep log period asks for up to 256 geometries)."""
    params = np.frombuffer(raw, dtype=dtype).reshape(shape)
    _, inv = np.unique(params, axis=0, return_inverse=True)
    return np.any(params != 0.0, axis=1), inv.reshape(-1)


def pr_geometry(params: np.ndarray, n_symmetries: int = 8,
                n_channels: int = 8):
    """``selected_pr_geometry`` bound to one bank: w -> (n_pr, dim,
    nz_dim). The bank's row groups are looked up once here, not once per
    call (the lookup hashes the whole bank; a sweep log period asks for up
    to 256 geometries, prstats for one per history row and dataset)."""
    params = np.ascontiguousarray(params)
    nonzero, group = _param_groups(params.tobytes(), params.shape,
                                   params.dtype.str)

    def geometry(w) -> Tuple[int, int, int]:
        w = np.asarray(w).reshape(-1)
        ids = group[np.repeat(w > 0.0, n_symmetries) & nonzero]
        nz_dim = ids.size
        if nz_dim == 0:
            return 0, 0, 0
        dup_rows = int(np.sum(np.bincount(ids)[ids] >= 2))
        n_pr = nz_dim - dup_rows // 2
        return n_pr, n_pr * n_channels, nz_dim

    return geometry


def selected_pr_geometry(params: np.ndarray, w: np.ndarray,
                         n_symmetries: int = 8,
                         n_channels: int = 8) -> Tuple[int, int, int]:
    """(n_pr, dim, nz_dim) for a PR weight vector, with the reference's
    dup_rows/2 counting convention (src/misc.cpp:196-217): a family of m
    equal selected rows adds m to dup_rows. Rows are grouped by equality
    over the whole bank once; the selected rows' groups give the counts."""
    return pr_geometry(params, n_symmetries, n_channels)(w)


def _geometry_record(geometry, w) -> dict:
    n_pr, dim, nz_dim = geometry(w)
    return {"n_pr": n_pr, "dim": dim, "nz_dim": nz_dim,
            "fpr95": None, "auc": None}


def _as_f32(w, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(w, np.float32)).to(like.device)


def compute_pr_stats(params: np.ndarray, dists: torch.Tensor,
                     labels: torch.Tensor, w, n_channels: int = 8,
                     max_dim: int = -1):
    """Full-dataset PR model stats (reference: src/misc.cpp:171-264);
    fpr95/auc are None when the model exceeds max_dim."""
    out = _geometry_record(pr_geometry(params, n_channels=n_channels), w)
    if max_dim != -1 and out["dim"] > max_dim:
        return out
    pd = torch.matmul(dists, _as_f32(w, dists).reshape(-1))
    fpr95, auc = roc_stats(pd, labels)
    out["fpr95"] = float(fpr95)
    out["auc"] = float(auc)
    return out


def _pr_split_distances(w, pos_trn, neg_trn, pos_val, neg_val):
    """Each split's PR model distances, split @ w in f32 (TF32 off); w
    (F,) or (1, F)."""
    w = w.reshape(-1).to(torch.float32)
    return tuple(torch.matmul(x, w)
                 for x in (pos_trn, neg_trn, pos_val, neg_val))


def _split_roc(pos_d_trn, neg_d_trn, pos_d_val, neg_d_val):
    pd = torch.cat([pos_d_trn, pos_d_val, neg_d_trn, neg_d_val])
    n_pos = pos_d_trn.shape[0] + pos_d_val.shape[0]
    labels = torch.zeros(pd.shape[0], dtype=torch.int32, device=pd.device)
    labels[:n_pos] = 1
    return roc_stats(pd, labels)


def compute_pr_stats_splits(params, splits, w, n_channels: int = 8,
                            max_dim: int = -1):
    """Full-dataset PR stats from the resident train/val splits: the full
    matrix is the union of the four splits and the ROC sweep is row-order
    invariant, so no second copy of the matrix is needed on the device.

    ``splits`` maps {pos_trn, neg_trn, pos_val, neg_val} to f32 tensors."""
    out = _geometry_record(pr_geometry(params, n_channels=n_channels), w)
    if max_dim != -1 and out["dim"] > max_dim:
        return out
    ds = _pr_split_distances(_as_f32(w, splits["pos_trn"]),
                             *(splits[k] for k in ("pos_trn", "neg_trn",
                                                   "pos_val", "neg_val")))
    fpr95, auc = _split_roc(*ds)
    out["fpr95"] = float(fpr95)
    out["auc"] = float(auc)
    return out


def compute_pr_stats_rows(params, dists: torch.Tensor, labels: torch.Tensor,
                          hist, n_channels: int = 8, max_dim: int = -1,
                          row_block: int = 64):
    """Stats for every row of a model history: each block of rows shares
    one product and one batched sort. Returns a list of dicts in row
    order, the fields of compute_pr_stats."""
    hist = np.asarray(hist)
    geometry = pr_geometry(params, n_channels=n_channels)
    out = [_geometry_record(geometry, hist[r]) for r in range(hist.shape[0])]
    eval_rows = [r for r, o in enumerate(out)
                 if max_dim == -1 or o["dim"] <= max_dim]
    for s in range(0, len(eval_rows), row_block):
        block = eval_rows[s:s + row_block]
        w_block = _as_f32(hist[block], dists)
        pd = torch.matmul(dists, w_block.T)                   # (N, R)
        fpr95, auc = roc_stats(pd.T, labels)
        fpr95, auc = fpr95.tolist(), auc.tolist()
        for j, r in enumerate(block):
            out[r]["fpr95"] = float(fpr95[j])
            out[r]["auc"] = float(auc[j])
    return out


def pj_model_distances(w_proj: torch.Tensor, diffs: torch.Tensor) -> torch.Tensor:
    """PatchDist = colsum((W diffs^T)^2) (reference: src/misc.cpp:286-290).
    Zero rows of W contribute nothing, so the full square W gives the
    reference's nonzero-row distances."""
    proj = torch.matmul(diffs, w_proj.T)
    return (proj * proj).sum(dim=1)


def _pj_stats_record(w_proj) -> dict:
    w_np = np.asarray(w_proj)
    return {"dim": int(np.sum(np.any(w_np != 0.0, axis=1)))}


def compute_pj_stats_splits(splits, w_proj) -> dict:
    """Full-dataset PJ stats from the resident splits (see
    compute_pr_stats_splits): dict(dim, fpr95, auc)."""
    out = _pj_stats_record(w_proj)
    wt = _as_f32(w_proj, splits["pos_trn"])
    ds = [pj_model_distances(wt, splits[k].to(torch.float32))
          for k in ("pos_trn", "neg_trn", "pos_val", "neg_val")]
    fpr95, auc = _split_roc(*ds)
    out["fpr95"] = float(fpr95)
    out["auc"] = float(auc)
    return out


def compute_pj_stats(diffs: torch.Tensor, labels: torch.Tensor,
                     w_proj) -> dict:
    """Full-dataset PJ model stats (reference: src/misc.cpp:266-333):
    dict(dim, fpr95, auc); dim counts the nonzero rows of W."""
    out = _pj_stats_record(w_proj)
    pd = pj_model_distances(_as_f32(w_proj, diffs), diffs)
    fpr95, auc = roc_stats(pd, labels)
    out["fpr95"] = float(fpr95)
    out["auc"] = float(auc)
    return out
