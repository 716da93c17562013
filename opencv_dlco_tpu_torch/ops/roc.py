"""ROC statistics: FPR@95% recall and area-under-curve.

Port of ``opencv_dlco_tpu/ops/roc.py`` (reference: src/misc.cpp:226-263):
a stable argsort and two cumulative sums give the ROC; the AUC is the
contour area of the ROC polygon closed with the point (1, 0), the
reference's cv::contourArea convention, by the shoelace formula. Leading
dimensions of ``dists`` are batch dimensions (one curve per model row).
"""

from __future__ import annotations

import torch


def roc_curve(dists: torch.Tensor, labels: torch.Tensor):
    """Ascending-distance ROC over the last dimension -> (tpr, fpr) float32."""
    order = torch.argsort(dists, dim=-1, stable=True)
    lab = labels.to(torch.float32)[order]
    tp = torch.cumsum(lab, dim=-1)
    fp = torch.cumsum(1.0 - lab, dim=-1)
    return tp / tp[..., -1:], fp / fp[..., -1:]


def roc_stats(dists: torch.Tensor, labels: torch.Tensor):
    """(fpr95, auc) for scored pairs; smaller distance = more similar."""
    tpr, fpr = roc_curve(dists, labels)
    # first FPR where TPR >= 0.95 (reference: src/misc.cpp:247-256)
    idx = torch.argmax((tpr >= 0.95).to(torch.int32), dim=-1, keepdim=True)
    fpr95 = torch.gather(fpr, -1, idx)[..., 0]
    ones = torch.ones(fpr.shape[:-1] + (1,), dtype=fpr.dtype,
                      device=fpr.device)
    xs = torch.cat([fpr, ones], dim=-1)
    ys = torch.cat([tpr, torch.zeros_like(ones)], dim=-1)
    cross = (xs * torch.roll(ys, -1, dims=-1)
             - torch.roll(xs, -1, dims=-1) * ys)
    auc = 0.5 * torch.abs(cross.sum(dim=-1))
    return fpr95, auc
