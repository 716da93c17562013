"""Batched k-nearest-neighbour descriptor matching.

Port of ``opencv_dlco_tpu/ops/knn.py``, the matching front end the learned
VGG descriptors feed. ``knn_match`` is a dispatcher: with ``fused="auto"``
it sends CUDA tensors to the fused kernels (``ops/knn_fused.py``: F for
k <= 2, H for k <= 16) when the problem has at least ``FUSED_MIN_PAIRS``
candidate pairs, and everything else (CPU tensors, k outside 1-16, 3-D
inputs, small problems) to the scan path,
``knn_match_scan``: column blocks of the distance matrix folded into a
running top-k with library PyTorch, so memory stays O(N * (k + block)).
``fused=True`` forces the kernels (their plain versions on the CPU);
``fused=False`` forces the scan path.

Both paths return (dists (N, k) ascending, idx (N, k) int32), equal
distances ordered by the lower train index, (inf, -1) where fewer than k
neighbours exist.
"""

from __future__ import annotations

import torch

from .knn_fused import MAX_K, knn2_fused, knnk_fused, lex_topk

#: auto-dispatch to the fused kernels only above this candidate-pair count
FUSED_MIN_PAIRS = 1 << 16


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, D), (M, D) -> (N, M) squared L2 distances, f32 (TF32 off)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    na = (a * a).sum(dim=1, keepdim=True)
    nb = (b * b).sum(dim=1, keepdim=True)
    return torch.clamp(na + nb.T - 2.0 * torch.matmul(a, b.T), min=0.0)


def knn_match_scan(query: torch.Tensor, train: torch.Tensor, k: int = 2,
                   block: int = 4096):
    """Scan path (the XLA path of the JAX package, ``_knn_match_xla``):
    f32 column blocks of ``block`` train rows, each folded into the
    running top-k; the full N x M matrix never exists."""
    q = query.to(torch.float32)
    n = q.shape[0]
    nq = (q * q).sum(dim=1, keepdim=True)
    best_d = torch.full((n, k), float("inf"), device=q.device)
    best_i = torch.full((n, k), -1, dtype=torch.int32, device=q.device)
    for off in range(0, train.shape[0], block):
        tb = train[off:off + block].to(torch.float32)
        ntb = (tb * tb).sum(dim=1, keepdim=True)
        dist = torch.clamp(nq + ntb.T - 2.0 * torch.matmul(q, tb.T), min=0.0)
        cols = torch.arange(off, off + tb.shape[0], dtype=torch.int32,
                            device=q.device).expand(n, -1)
        cand_i = torch.cat([best_i, cols], dim=1)
        # running entries first: on equal distances the earlier (lower)
        # train index wins, as lax.top_k's lower-position rule does
        best_d, pos = lex_topk(torch.cat([best_d, dist], dim=1), k)
        best_i = torch.gather(cand_i, 1, pos.clamp(min=0).to(torch.int64))
        best_i = torch.where(torch.isfinite(best_d), best_i,
                             torch.full_like(best_i, -1))
    return best_d, best_i


def _fused_eligible(query: torch.Tensor, train: torch.Tensor,
                    k: int) -> bool:
    """Auto-dispatch gate: CUDA tensors, a supported k, 2-D inputs, and a
    problem large enough to beat the launch overhead."""
    if query.device.type != "cuda" or train.device.type != "cuda":
        return False
    if not 1 <= k <= MAX_K:
        return False
    if query.ndim != 2 or train.ndim != 2:
        return False
    return query.shape[0] * train.shape[0] >= FUSED_MIN_PAIRS


def knn_match(query: torch.Tensor, train: torch.Tensor, k: int = 2,
              block: int = 4096, precision: str = "default",
              fused="auto"):
    """Top-k nearest training descriptors per query.

    Returns (dists (N, k) ascending, idx (N, k) int32; idx -1 / dist inf
    where fewer than k real neighbours exist).

    ``precision`` picks the fused kernels' mode: "default" rounds the
    descriptors to bf16 (f32 accumulation), "highest" is true f32. The scan
    path computes in f32 either way (the JAX scan path on the CPU does).

    ``fused``: "auto" (default) dispatches to the kernels when profitable;
    True forces them; False forces the scan path.
    """
    bf16 = precision != "highest"
    use_fused = fused if isinstance(fused, bool) else _fused_eligible(
        query, train, k)
    if use_fused:
        if k <= 2:
            d2, i2 = knn2_fused(query, train, bf16=bf16)
            return d2[:, :k], i2[:, :k]
        return knnk_fused(query, train, k, bf16=bf16)
    return knn_match_scan(query, train, k=k, block=block)


def ratio_test(dists: torch.Tensor, idx: torch.Tensor, ratio: float = 0.8):
    """Lowe ratio test on 2-NN results: (match_idx (N,), mask (N,))."""
    ok = dists[:, 0] < (ratio * ratio) * dists[:, 1]  # squared distances
    return torch.where(ok, idx[:, 0], torch.full_like(idx[:, 0], -1)), ok


def mutual_nearest(query: torch.Tensor, train: torch.Tensor,
                   block: int = 4096, fused="auto"):
    """Mutual 1-NN cross-check: (idx (N,) into train, -1 where not mutual;
    mask (N,)). Both directions go through knn_match's dispatcher."""
    _, i_qt = knn_match(query, train, k=1, block=block, fused=fused)
    _, i_tq = knn_match(train, query, k=1, block=block, fused=fused)
    back = i_tq[i_qt[:, 0].clamp(min=0).to(torch.int64), 0]
    ok = (back == torch.arange(query.shape[0], dtype=torch.int32,
                               device=back.device)) & (i_qt[:, 0] >= 0)
    return torch.where(ok, i_qt[:, 0], torch.full_like(i_qt[:, 0], -1)), ok
