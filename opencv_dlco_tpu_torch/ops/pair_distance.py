"""Pooled descriptors and per-ring pair distances, float32 ("highest" route).

Port of ``opencv_dlco_tpu/ops/pair_distance.py`` (reference:
src/comp-fulldists.cpp:294-356, src/comp-uprjdists.cpp:298-349). A block of
pairs pools through the filter bank as one wide float32 product (TF32 off),
followed by truncation at 1, the squared difference and the two-stage ring
reduction. The bf16 route is the fused kernel in ops/pair_distance_fused.py.
``precision="default"`` rounds the operands of a product to bf16 (f32
accumulation), the precision class of the TPU's DEFAULT matmul.
"""

from __future__ import annotations

import torch


def pooled_descriptors(filters: torch.Tensor, patch_trans: torch.Tensor,
                       precision: str = "highest") -> torch.Tensor:
    """min(F @ PT, 1): (n_filters, n_pixels) x (B, n_pixels, n_bins) -> (B, n_filters, n_bins)."""
    if precision != "highest":
        filters = filters.to(torch.bfloat16).to(torch.float32)
        patch_trans = patch_trans.to(torch.bfloat16).to(torch.float32)
    d = torch.matmul(filters, patch_trans)
    return torch.clamp(d, max=1.0)


def ring_distances(filters: torch.Tensor, pt1: torch.Tensor,
                   pt2: torch.Tensor, n_symmetries: int = 8) -> torch.Tensor:
    """(B, n_rings) float32: sum over bins and the symmetric offsets of a
    ring of (trunc(F@PT2) - trunc(F@PT1))^2. Filters are ring-major
    (n_symmetries consecutive rows per ring)."""
    d1 = pooled_descriptors(filters, pt1)
    d2 = pooled_descriptors(filters, pt2)
    sq = (d2 - d1) ** 2
    b, f, _ = sq.shape
    per_filter = sq.sum(dim=2)
    return per_filter.reshape(b, f // n_symmetries, n_symmetries).sum(dim=2)


def unprojected_diffs(sel_filters: torch.Tensor, pt1: torch.Tensor,
                      pt2: torch.Tensor,
                      precision: str = "highest") -> torch.Tensor:
    """(B, n_sel * n_bins) rows of (Desc1 - Desc2) flattened row-major
    (reference: src/comp-uprjdists.cpp:320-330)."""
    diff = (pooled_descriptors(sel_filters, pt1, precision)
            - pooled_descriptors(sel_filters, pt2, precision))
    return diff.reshape(diff.shape[0], -1)
