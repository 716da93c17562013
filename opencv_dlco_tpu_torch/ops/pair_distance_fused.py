"""Kernel A: fused stage-3 ring distances (bf16 inputs, f32 accumulation).

Port of ``opencv_dlco_tpu/ops/pair_distance_pallas.py::ring_distances_fused``.
On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/ring_dist.cu`` (wgmma products fed by TMA, truncation, squared
difference and ring reduction fused; the pooled descriptors never reach
device memory); on a CPU tensor it runs ``ring_distances_plain``, the same
function in plain PyTorch. The wrapper's host-side layout (pairs padded to
the pair tile, one pair's 8 channels as 8 pixel-contiguous rows) is
``pair_columns``. Bound and design: see the kernel source.
"""

from __future__ import annotations

import torch

from . import cuda_build

N_SYM = 8   # symmetric offsets per ring
N_CH = 8    # angle channels
TF = 128    # filters per CTA (the filter count must be a multiple)
TP = 16     # pairs per CTA (pairs are zero-padded to a multiple)
TK = 64     # pixels per stage (the pixel count must be a multiple)


def pair_columns(pt: torch.Tensor) -> torch.Tensor:
    """The kernel's column operand of one side: (B, n_pixels, 8) ->
    (B_pad, 8, n_pixels) bf16, B padded with zero pairs to a multiple of
    TP. Row 8 * p + c is pair p's channel c, contiguous in pixels (the
    K-major layout the tensor-map tiles load)."""
    b, npix, nch = pt.shape
    cols = torch.zeros((b + (-b) % TP, nch, npix), dtype=torch.bfloat16,
                       device=pt.device)
    cols[:b] = pt.transpose(1, 2)
    return cols


def ring_distances_plain(filters: torch.Tensor, pt1: torch.Tensor,
                         pt2: torch.Tensor, *, bf16: bool = False
                         ) -> torch.Tensor:
    """Plain PyTorch version of kernel A: inputs rounded to bf16 when
    ``bf16``, products and sums in f32. (B, n_filters // 8) float32."""
    def q(x):
        return x.to(torch.bfloat16).to(torch.float32) if bf16 \
            else x.to(torch.float32)

    f = q(filters)
    d1 = torch.clamp(torch.matmul(f, q(pt1)), max=1.0)
    d2 = torch.clamp(torch.matmul(f, q(pt2)), max=1.0)
    per_filter = ((d2 - d1) ** 2).sum(dim=2)
    b, nf = per_filter.shape
    return per_filter.reshape(b, nf // N_SYM, N_SYM).sum(dim=2)


def ring_distances_fused(filters: torch.Tensor, pt1: torch.Tensor,
                         pt2: torch.Tensor, *, bf16: bool = False
                         ) -> torch.Tensor:
    """Fused equivalent of ops.pair_distance.ring_distances.

    filters: (n_filters, n_pixels), ring-major, n_filters % 128 == 0 and
    n_pixels % 64 == 0 (pass it as bf16 to skip the per-call cast);
    pt1/pt2: (B, n_pixels, 8). Returns (B, n_filters // 8) float32.
    The CUDA kernel takes bf16 inputs only (``bf16=True``).
    """
    nf, npix = filters.shape
    b = pt1.shape[0]
    if nf % TF:
        raise ValueError(f"n_filters {nf} not a multiple of {TF}")
    if npix % TK:
        raise ValueError(f"n_pixels {npix} not a multiple of {TK}")
    if pt1.shape != (b, npix, N_CH) or pt2.shape != pt1.shape:
        raise ValueError(f"pt1/pt2 must be ({b}, {npix}, {N_CH}); got "
                         f"{tuple(pt1.shape)}, {tuple(pt2.shape)}")
    if filters.device.type == "cpu":
        return ring_distances_plain(filters, pt1, pt2, bf16=bf16)
    if not bf16:
        raise NotImplementedError(
            "the CUDA ring-distance kernel takes bf16 inputs (bf16=True); "
            "the f32 route is ops.pair_distance.ring_distances")
    dev = filters.device
    if pt1.device != dev or pt2.device != dev:
        raise ValueError("filters, pt1 and pt2 must be on one device")
    f16 = filters.to(torch.bfloat16).contiguous()
    if f16.data_ptr() % 16:
        raise ValueError("ring_distances_fused: the bank must be 16-byte "
                         "aligned (tensor-map tiles)")
    # one pair's 8 channels are one n8 slice of the wgmma accumulator
    p1, p2 = pair_columns(pt1), pair_columns(pt2)
    bp = p1.shape[0]
    out = torch.empty((b, nf // N_SYM), dtype=torch.float32, device=dev)
    lib = cuda_build.load("ring_dist")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ring_dist_launch(f16.data_ptr(), p1.data_ptr(),
                                  p2.data_ptr(), out.data_ptr(), nf, npix,
                                  bp, b, stream)
    cuda_build.check(rc, "ring_distances_fused")
    ring_distances_fused.launches += 1
    return out


#: kernel launches since the count was last set to 0
ring_distances_fused.launches = 0
