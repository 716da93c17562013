"""Kernels F, G and H: fused k-NN, distance products and a running top-k
in one pass (``csrc/knn.cu``).

Port of ``opencv_dlco_tpu/ops/knn_pallas.py``:

- ``knn2_fused``: kernel F, the 2 nearest train rows of every query;
- ``knn2_fused_batched``: kernel G, F over a leading batch axis (the SLAM
  pose chunk's C matching problems, one launch, the batch on grid z);
- ``knnk_fused``: kernel H, the k nearest for 1 <= k <= 16.

All compute ||q||^2 + ||t||^2 - 2 q.t clamped at 0 and return (dists
(N, k) f32 ascending, idx (N, k) int32), equal distances ordered by the
lower train index, (inf, -1) where a query has fewer than k neighbours.
``bf16=True`` rounds q and t to bf16 before the norms and the products
(the TPU kernels' fast mode); ``bf16=False`` is true f32, TF32 off.
``_fused_call`` takes the leading batch axis, as the TPU's ``_fused_call``
does.

On a CPU tensor each wrapper runs ``knn_plain``, the same function in
plain PyTorch; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_build

MAX_K = 16
PLAIN_BLOCK = 4096     # queries per distance block of the plain version


def lex_topk(dist: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (dist, column) pairs of each row of ``dist`` (>= 0 or
    inf, f32) in lexicographic order: ascending distance, equal distances
    by the lower column. Returns (d, idx int32) of shape (..., k), (inf, -1)
    past the row length and where the distance is not finite.

    The key packs the distance's bits above the column index, so one
    integer top-k orders exactly (f32 bits of non-negative values are
    monotonic in the value)."""
    m = dist.shape[-1]
    kk = min(k, m)
    dist = dist.to(torch.float32).contiguous() + 0.0   # -0.0 -> +0.0
    cols = torch.arange(m, device=dist.device, dtype=torch.int64)
    key = (dist.view(torch.int32).to(torch.int64) << 32) | cols
    top = torch.topk(key, kk, dim=-1, largest=False, sorted=True).values
    idx = (top & 0xFFFFFFFF).to(torch.int64)
    d = torch.gather(dist, -1, idx)
    idx = idx.to(torch.int32)
    if kk < k:
        pad = dist.shape[:-1] + (k - kk,)
        d = torch.cat([d, torch.full(pad, float("inf"), device=d.device)], -1)
        idx = torch.cat([idx, torch.full(pad, -1, dtype=torch.int32,
                                         device=d.device)], -1)
    idx = torch.where(torch.isfinite(d), idx, torch.full_like(idx, -1))
    return d, idx


def knn_plain(query: torch.Tensor, train: torch.Tensor, k: int, *,
              bf16: bool = True):
    """Plain PyTorch version of kernels F and H: (N, D) x (M, D) -> (dists
    (N, k), idx (N, k)); a leading batch axis on both is carried through.
    Queries go in blocks of PLAIN_BLOCK rows, so at most (PLAIN_BLOCK, M)
    distances exist at once."""
    batched = query.ndim == 3
    q = query if batched else query[None]
    t = train if batched else train[None]
    if bf16:
        q = q.to(torch.bfloat16)
        t = t.to(torch.bfloat16)
    q = q.to(torch.float32)
    t = t.to(torch.float32)
    nq = (q * q).sum(-1)
    nt = (t * t).sum(-1)
    ds, ids = [], []
    for b in range(q.shape[0]):
        db, ib = [], []
        for s in range(0, q.shape[1], PLAIN_BLOCK):
            g = torch.matmul(q[b, s:s + PLAIN_BLOCK], t[b].T)
            dist = torch.clamp(nq[b, s:s + PLAIN_BLOCK, None] + nt[b, None, :]
                               - 2.0 * g, min=0.0)
            d, i = lex_topk(dist, k)
            db.append(d)
            ib.append(i)
        ds.append(torch.cat(db) if db else
                  torch.empty((0, k), device=q.device))
        ids.append(torch.cat(ib) if ib else
                   torch.empty((0, k), dtype=torch.int32, device=q.device))
    d, i = torch.stack(ds), torch.stack(ids)
    return (d, i) if batched else (d[0], i[0])


def _fused_call(query: torch.Tensor, train: torch.Tensor, k: int, *,
                bf16: bool, wrapper):
    """Shared launcher: (B, N, D) x (B, M, D) -> ((B, N, k), (B, N, k)).
    Counts a launch on ``wrapper.launches``."""
    what = wrapper.__name__
    b, n, d = query.shape
    if train.ndim != 3 or train.shape[0] != b or train.shape[2] != d:
        raise ValueError(f"{what}: train {tuple(train.shape)} does not match "
                         f"query {tuple(query.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{what}: supports 1 <= k <= {MAX_K}, got {k}")
    if query.device != train.device:
        raise ValueError(f"{what}: query and train must share a device")
    if query.device.type == "cpu":
        return knn_plain(query, train, k, bf16=bf16)
    dev = query.device
    dt = torch.bfloat16 if bf16 else torch.float32
    q = query.to(dt)
    t = train.to(dt)
    pad = (-d) % 16 if bf16 else 0
    if pad:  # zero columns change neither the products nor the norms
        q = torch.nn.functional.pad(q, (0, pad))
        t = torch.nn.functional.pad(t, (0, pad))
    q, t = q.contiguous(), t.contiguous()
    # the kernel's 16-byte copies need a 16-byte aligned base
    q = q.clone() if q.data_ptr() % 16 else q
    t = t.clone() if t.data_ptr() % 16 else t
    m = t.shape[1]
    od = torch.empty((b, n, k), dtype=torch.float32, device=dev)
    oi = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    if n == 0:
        return od, oi
    qn = torch.empty((b, n), dtype=torch.float32, device=dev)
    tn = torch.empty((b, m), dtype=torch.float32, device=dev)
    lib = cuda_build.load("knn")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.knn_launch(int(bf16), q.data_ptr(), t.data_ptr(),
                            qn.data_ptr(), tn.data_ptr(), od.data_ptr(),
                            oi.data_ptr(), b, n, m, d + pad, k, q.stride(0),
                            q.stride(1), t.stride(0), t.stride(1), stream)
    cuda_build.check(rc, what)
    wrapper.launches += 1
    return od, oi


def knn2_fused(query: torch.Tensor, train: torch.Tensor, *,
               bf16: bool = True):
    """2-NN of every query against train (kernel F): (dists (N, 2)
    ascending, idx (N, 2) int32)."""
    od, oi = _fused_call(query[None], train[None], 2, bf16=bf16,
                         wrapper=knn2_fused)
    return od[0], oi[0]


def knn2_fused_batched(query: torch.Tensor, train: torch.Tensor, *,
                       bf16: bool = False):
    """Batched 2-NN (kernel G): (B, N, D) x (B, M, D) -> (dists (B, N, 2),
    idx (B, N, 2)) in one launch. Default f32 (TF32 off): pose estimation
    is sensitive to match identity, and f32 is the mode the reference ran
    it in."""
    return _fused_call(query, train, 2, bf16=bf16,
                       wrapper=knn2_fused_batched)


def knnk_fused(query: torch.Tensor, train: torch.Tensor, k: int, *,
               bf16: bool = True):
    """Top-k (1 <= k <= 16) per query (kernel H): (dists (N, k) ascending,
    idx (N, k) int32)."""
    od, oi = _fused_call(query[None], train[None], k, bf16=bf16,
                         wrapper=knnk_fused)
    return od[0], oi[0]


#: kernel launches since the count was last set to 0
knn2_fused.launches = 0
knn2_fused_batched.launches = 0
knnk_fused.launches = 0
