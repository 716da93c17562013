"""All-pairs hinge loss between positive and negative distance vectors.

    L(pos, neg) = sum_i sum_j max(0, pos_i + 1 - neg_j)

Port of ``opencv_dlco_tpu/ops/hinge.py`` (the reference's
kSubtractVectorsByRows, src/kernelop-opencv.cu:49-66):

- ``hinge_sum_sorted``: the exact O((P+N) log N) form. Sort the negatives;
  for each positive the inner sum is k(p) * (p + 1) - prefix[k(p)] with
  k(p) = #{ j : n_j < p + 1 }. Leading dimensions are batch dimensions (one
  loss per sweep entry). The validation path of both learners.
- ``hinge_sum_blockwise``: kernel E, the all-pairs form with per-positive
  partial sums (``csrc/hinge.cu``), kept for summation-order parity;
  ``hinge_partials`` returns the kernel's partials. On a CPU tensor both
  run ``hinge_partials_plain``.
- ``hinge_sum``: the dispatcher, sorted by default.
"""

from __future__ import annotations

import torch

from . import cuda_build

TILE_N = 2048  # negatives per partial sum of the plain version (the TPU tile)
TILE_P = 1024  # positives per CTA of kernel E (csrc/hinge.cu)


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


def hinge_partials_plain(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel E: (P,) per-positive sums of
    max(0, p + 1 - n) over the negatives, in TILE_N-wide negative tiles,
    so no P x N matrix is held at once."""
    th = pos.reshape(-1).to(torch.float32) + 1.0
    neg = neg.reshape(-1).to(torch.float32)
    out = torch.zeros_like(th)
    for j in range(0, neg.shape[0], TILE_N):
        out += torch.clamp(th[:, None] - neg[None, j:j + TILE_N],
                           min=0.0).sum(dim=1)
    return out


def _flat(pos: torch.Tensor, neg: torch.Tensor, what: str):
    pos = pos.reshape(-1).to(torch.float32).contiguous()
    neg = neg.reshape(-1).to(torch.float32).contiguous()
    if pos.device != neg.device:
        raise ValueError(f"{what}: pos and neg must share a device")
    return pos, neg


def _kernel_e(pos: torch.Tensor, neg: torch.Tensor):
    """Kernel E on flat f32 CUDA tensors, P > 0: (per-positive sums (P,),
    their total, 0-d), both from one launch (and a memset of the kernel's
    counters)."""
    n_pos, n_neg = pos.shape[0], neg.shape[0]
    if neg.data_ptr() % 16:
        neg = neg.clone()  # the kernel copies whole float4s
    dev = pos.device
    n_pb = -(-n_pos // TILE_P)
    lib = cuda_build.load("hinge")
    with torch.cuda.device(dev):
        n_slices = lib.hinge_slices(n_pos, n_neg)
        cuda_build.check(max(0, -n_slices), "hinge_sum_blockwise")
        # one allocation: per_pos (16-byte aligned), the total, the
        # slices' partials, the block counters (u32, zeroed by the launch)
        n_pad = -(-n_pos // 4) * 4
        buf = torch.empty(n_pad + 4 + n_slices * n_pos + n_pb + 1,
                          dtype=torch.float32, device=dev)
        per_pos, total = buf[:n_pos], buf[n_pad]
        ptr, f4 = buf.data_ptr(), 4
        rc = lib.hinge_launch(
            pos.data_ptr(), neg.data_ptr(), ptr, ptr + f4 * n_pad,
            ptr + f4 * (n_pad + 4), ptr + f4 * (n_pad + 4 + n_slices * n_pos),
            n_pos, n_neg, n_slices, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, "hinge_sum_blockwise")
    hinge_sum_blockwise.launches += 1
    return per_pos, total


def hinge_partials(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """(P,) per-positive sums of max(0, p + 1 - n): kernel E's on CUDA
    tensors, the plain version's on CPU tensors."""
    pos, neg = _flat(pos, neg, "hinge_partials")
    if pos.device.type == "cpu":
        return hinge_partials_plain(pos, neg)
    return _kernel_e(pos, neg)[0] if pos.shape[0] else torch.zeros_like(pos)


def hinge_sum_blockwise(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """All-pairs hinge sum through kernel E: per-positive partial sums and
    their total in one launch, each added in a fixed order (two calls give
    the same bits). Inputs are flattened; the P x N matrix never exists.
    Returns a 0-d f32 tensor."""
    pos, neg = _flat(pos, neg, "hinge_sum_blockwise")
    if pos.device.type == "cpu":
        return hinge_partials_plain(pos, neg).sum()
    if not pos.shape[0]:
        return torch.zeros((), dtype=torch.float32, device=pos.device)
    return _kernel_e(pos, neg)[1]


#: kernel launches since the count was last set to 0
hinge_sum_blockwise.launches = 0


def hinge_sum(pos: torch.Tensor, neg: torch.Tensor, *,
              method: str = "sorted") -> torch.Tensor:
    """All-pairs hinge loss sum; ``method`` in {"sorted", "blockwise"}."""
    if method == "sorted":
        return hinge_sum_sorted(pos.reshape(-1), neg.reshape(-1))
    if method == "blockwise":
        return hinge_sum_blockwise(pos, neg)
    raise ValueError(f"unknown hinge method: {method}")
