"""Descriptor evaluation protocols (HPatches-style).

Port of ``opencv_dlco_tpu/pipeline/eval.py``. Three tasks over learned
descriptors (the reference only evaluates verification, via FPR95/AUC on
labelled pairs, src/misc.cpp:171-264):

- verification: FPR95/AUC over labelled descriptor pairs (ops/roc.py);
- matching: mean average precision of nearest-neighbour matching between
  two views with known ground-truth correspondence (ops/knn.knn_match, so
  kernel H at k = 10 on the card);
- retrieval: mAP of ranking a gallery by distance to each query, multiple
  positives per query.

Inputs are descriptor tensors (or numpy arrays, taken as CPU tensors); the
math runs on their device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.knn import knn_match, pairwise_sq_dists
from ..ops.roc import roc_stats


def _t(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def verification(desc_a, desc_b, labels) -> Dict[str, float]:
    """Labelled pairs (N, D) x2 + {0,1} (N,) -> FPR95 / AUC."""
    a = _t(desc_a).to(torch.float32)
    b = _t(desc_b).to(device=a.device, dtype=torch.float32)
    d = ((a - b) ** 2).sum(dim=1)
    fpr95, auc = roc_stats(d, _t(labels).to(a.device))
    return {"fpr95": float(fpr95), "auc": float(auc)}


def matching_map(query, train, gt_idx, k: int = 10) -> Dict[str, float]:
    """Matching mAP: for each query, gt_idx gives its true partner in train
    (-1 = no partner). AP per query = 1/rank of the true partner within the
    top-k candidates (0 if absent); mAP averages over valid queries.
    Also reports precision@1.
    """
    query = _t(query)
    train = _t(train).to(query.device)
    gt = _t(gt_idx).to(query.device)
    _, idx = knn_match(query, train, k=k, block=min(4096, train.shape[0]))
    hits = idx == gt[:, None]                       # (N, k)
    rank = torch.argmax(hits.to(torch.int32), dim=1)  # first hit position
    found = hits.any(dim=1)
    ap = torch.where(found, 1.0 / (rank + 1.0),
                     torch.zeros((), device=query.device))
    valid = gt >= 0
    n_valid = torch.clamp(valid.sum(), min=1)
    m_ap = torch.where(valid, ap, torch.zeros_like(ap)).sum() / n_valid
    p_at_1 = (valid & hits[:, 0]).sum() / n_valid
    return {"map": float(m_ap), "precision_at_1": float(p_at_1),
            "n_queries": int(valid.sum())}


def retrieval_map(query, gallery, query_labels,
                  gallery_labels) -> Dict[str, float]:
    """Retrieval mAP: rank the gallery per query; positives share the
    query's label. Standard interpolated AP over the full ranking."""
    query = _t(query)
    gallery = _t(gallery).to(query.device)
    ql = _t(query_labels).to(query.device)
    gl = _t(gallery_labels).to(query.device)
    d = pairwise_sq_dists(query, gallery)           # (Q, G)
    order = torch.argsort(d, dim=1, stable=True)
    rel = (gl[order] == ql[:, None]).to(torch.float32)  # (Q, G) ranked
    cum = torch.cumsum(rel, dim=1)
    ranks = torch.arange(1, rel.shape[1] + 1, dtype=torch.float32,
                         device=rel.device)
    precision = cum / ranks[None, :]
    n_pos = torch.clamp(rel.sum(dim=1), min=1.0)
    ap = (precision * rel).sum(dim=1) / n_pos
    return {"map": float(ap.mean()), "n_queries": int(query.shape[0])}


def evaluate_descriptor(model, patch_pairs, labels) -> Dict[str, float]:
    """Verification on uint8 patch pairs with a VGGDescriptor-like model
    (has .describe)."""
    p1, p2 = patch_pairs
    d1 = model.describe(p1)
    d2 = model.describe(p2)
    return verification(d1, d2, _t(labels).to(d1.device))
