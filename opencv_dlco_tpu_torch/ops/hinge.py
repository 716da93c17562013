"""All-pairs hinge loss between positive and negative distance vectors.

    L(pos, neg) = sum_i sum_j max(0, pos_i + 1 - neg_j)

Port of ``opencv_dlco_tpu/ops/hinge.py::hinge_sum_sorted`` (the reference's
kSubtractVectorsByRows, src/kernelop-opencv.cu:49-66, in exact O((P+N) log N)
form): sort the negatives, then for each positive the inner sum is
k(p) * (p + 1) - prefix[k(p)] with k(p) = #{ j : n_j < p + 1 }.
Leading dimensions are batch dimensions (one loss per sweep entry).
"""

from __future__ import annotations

import torch


def hinge_sum_sorted(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Exact all-pairs hinge over the last dimension; (..., P), (..., N) -> (...)."""
    pos = pos.to(torch.float32)
    ns = torch.sort(neg.to(torch.float32), dim=-1).values
    zero = torch.zeros(ns.shape[:-1] + (1,), dtype=torch.float32,
                       device=ns.device)
    prefix = torch.cat([zero, torch.cumsum(ns, dim=-1)], dim=-1)
    thresh = pos + 1.0
    # k = number of negatives strictly below pos + 1 <=> side='left'
    k = torch.searchsorted(ns.contiguous(), thresh.contiguous(), right=False)
    loss = thresh * k.to(torch.float32) - torch.gather(prefix, -1, k)
    return loss.sum(dim=-1)
