"""Kernels F, G and H: fused k-NN, distance products and a running top-k
in one pass.

Port of ``opencv_dlco_tpu/ops/knn_pallas.py``:

- ``knn2_fused``: kernel F, the 2 nearest train rows of every query
  (``csrc/knn_topk.cu``'s pair selection);
- ``knn2_fused_batched``: kernel G, the 2-NN over a leading batch axis (the
  SLAM pose chunk's C matching problems, one launch;
  ``csrc/knn_batched.cu``);
- ``knnk_fused``: kernel H, the k nearest for 1 <= k <= 16
  (``csrc/knn_topk.cu``, wgmma products and a pruned selection).

All compute ||q||^2 + ||t||^2 - 2 q.t clamped at 0 and return (dists
(N, k) f32 ascending, idx (N, k) int32), equal distances ordered by the
lower train index, (inf, -1) where a query has fewer than k neighbours.
``bf16=True`` rounds q and t to bf16 before the norms and the products
(the TPU kernels' fast mode); ``bf16=False`` is f32 parity (HIGHEST): on
the card each product is three tf32 wgmma products of the operands'
split hi + lo parts (the TPU's multi-pass bf16 HIGHEST product in Hopper's
terms), the plain version one f32 matmul with TF32 off.
The launchers take the leading batch axis, as the TPU's ``_fused_call``
does. F and H in bf16 and G are one kernel launch a call, the norms
computed inside (f32 inputs to the bf16 mode are cast first); F and H in
f32 are two: the split of q and t with their norms, then the kernel.

On a CPU tensor each wrapper runs ``knn_plain``, the same function in
plain PyTorch; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

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


_FNS: Dict[str, object] = {}


def _entry(lib: str, symbol: str):
    """C entry point ``symbol`` of library ``lib``, loaded (built first if
    needed) and looked up once."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = _FNS[symbol] = getattr(cuda_build.load(lib), symbol)
    return fn


def _run(dev: torch.device, fn, *args) -> int:
    """Call a launch entry point on PyTorch's current stream of ``dev``,
    switching the current device only when ``dev`` is not already it."""
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx == torch.cuda.current_device():
        return fn(*args, _raw_stream(idx))
    with torch.cuda.device(idx):
        return fn(*args, _raw_stream(idx))


def _raw_stream(idx: int) -> int:
    """The current stream's handle on device ``idx`` (PyTorch's raw-handle
    query where it exists: a Stream object per call costs ~10 us of host
    time on the H100 host)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(idx)
    return torch.cuda.current_stream(idx).cuda_stream


def _check_args(query: torch.Tensor, train: torch.Tensor, k: int,
                what: str) -> None:
    if query.ndim != 3 or train.ndim != 3 or train.shape[0] != query.shape[0] \
            or train.shape[2] != query.shape[2]:
        raise ValueError(f"{what}: train {tuple(train.shape)} does not match "
                         f"query {tuple(query.shape)}")
    if query.shape[2] < 1:
        raise ValueError(f"{what}: descriptors need at least one element")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{what}: supports 1 <= k <= {MAX_K}, got {k}")
    if query.device != train.device:
        raise ValueError(f"{what}: query and train must share a device")


def _bf16_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x in bf16, D padded with ``pad`` zero columns (which change neither
    the products nor the norms), contiguous, 16-byte aligned (the kernels'
    16-byte copies and tensor maps need it)."""
    x = x.to(torch.bfloat16)
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _empty_result(b: int, n: int, k: int, dev) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """(inf, -1) everywhere: the answer when there are no train rows."""
    return (torch.full((b, n, k), float("inf"), device=dev),
            torch.full((b, n, k), -1, dtype=torch.int32, device=dev))


def _fused_call(query: torch.Tensor, train: torch.Tensor, k: int, *,
                bf16: bool, wrapper):
    """Kernels F and H: (B, N, D) x (B, M, D) -> ((B, N, k), (B, N, k)).
    CPU tensors: ``knn_plain``; CUDA tensors: ``csrc/knn_topk.cu`` (k <= 2
    takes the pair selection), bf16 in one launch with the norms inside,
    f32 as the split of q and t with their norms, then the kernel. Counts
    a launch on ``wrapper.launches``."""
    what = wrapper.__name__
    _check_args(query, train, k, what)
    if query.device.type == "cpu":
        return knn_plain(query, train, k, bf16=bf16)
    dev = query.device
    b, n, d = query.shape
    m = train.shape[1]
    if bf16:
        pad = (-d) % 8  # rows of whole 16-byte units (the tensor maps' stride)
        q, t = _bf16_rows(query, pad), _bf16_rows(train, pad)
    else:
        q = query.to(torch.float32).contiguous()
        t = train.to(torch.float32).contiguous()
    if b == 0 or n == 0 or m == 0:
        return _empty_result(b, n, k, dev)
    od = torch.empty((b, n, k), dtype=torch.float32, device=dev)
    oi = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    if bf16:
        rc = _run(dev, _entry("knn_topk", "knn_topk_launch"), q.data_ptr(),
                  t.data_ptr(), od.data_ptr(), oi.data_ptr(), b, n, m,
                  d + pad, k)
    else:
        nbytes = _entry("knn_topk", "knn_topk_f32_scratch_bytes")(b, n, m, d)
        scratch = torch.empty((nbytes + 3) // 4, dtype=torch.float32,
                              device=dev)
        rc = _run(dev, _entry("knn_topk", "knn_topk_f32_launch"),
                  q.data_ptr(), t.data_ptr(), scratch.data_ptr(),
                  od.data_ptr(), oi.data_ptr(), b, n, m, d, k)
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
    """Batched 2-NN (kernel G, ``csrc/knn_batched.cu``): (B, N, D) x
    (B, M, D) -> (dists (B, N, 2), idx (B, N, 2)) in one launch, the two
    outputs views of one buffer. Default f32 (TF32 off): pose estimation is
    sensitive to match identity, and f32 is the mode the reference ran it
    in; ``bf16=True`` rounds q and t to bf16 first (products stay f32)."""
    _check_args(query, train, 2, "knn2_fused_batched")
    if query.device.type == "cpu":
        return knn_plain(query, train, 2, bf16=bf16)
    dev = query.device
    b, n, d = query.shape
    m = train.shape[1]
    q, t = query, train
    if bf16:
        q, t = q.to(torch.bfloat16), t.to(torch.bfloat16)
    if q.dtype != torch.float32:
        q = q.to(torch.float32)
    if t.dtype != torch.float32:
        t = t.to(torch.float32)
    q = q if q.stride(2) == 1 else q.contiguous()
    t = t if t.stride(2) == 1 else t.contiguous()
    if b == 0 or n == 0 or m == 0:
        return _empty_result(b, n, 2, dev)
    dists, idx = torch.empty((2, b, n, 2), device=dev).unbind(0)
    rc = _run(dev, _entry("knn_batched", "knn2_batched_launch"),
              q.data_ptr(), t.data_ptr(), dists.data_ptr(), b, n, m, d,
              q.stride(0), q.stride(1), t.stride(0), t.stride(1))
    cuda_build.check(rc, "knn2_fused_batched")
    knn2_fused_batched.launches += 1
    return dists, idx.view(torch.int32)


def knnk_fused(query: torch.Tensor, train: torch.Tensor, k: int, *,
               bf16: bool = True):
    """Top-k (1 <= k <= 16) per query (kernel H): (dists (N, k) ascending,
    idx (N, k) int32). On a CUDA tensor: ``csrc/knn_topk.cu`` at every
    width, in either mode."""
    od, oi = _fused_call(query[None], train[None], k, bf16=bf16,
                         wrapper=knnk_fused)
    return od[0], oi[0]


#: kernel launches since the count was last set to 0
knn2_fused.launches = 0
knn2_fused_batched.launches = 0
knnk_fused.launches = 0
