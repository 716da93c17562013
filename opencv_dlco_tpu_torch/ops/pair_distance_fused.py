"""Kernel A: fused stage-3 ring distances, in two modes: bf16 (bf16
inputs, f32 accumulation) and f32 (HIGHEST parity: 3xTF32 products).

Port of ``opencv_dlco_tpu/ops/pair_distance_pallas.py::ring_distances_fused``.
On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/ring_dist.cu`` (wgmma products fed by TMA, truncation, squared
difference and ring reduction fused; the pooled descriptors never reach
device memory), in the mode ``bf16`` names; on a CPU tensor it runs
``ring_distances_plain``, the same function in plain PyTorch. The bf16
mode's host-side layout (pairs padded to the pair tile, one pair's 8
channels as 8 pixel-contiguous rows) is ``pair_columns``; the f32 mode
splits every element into tf32 hi and lo planes on the card, the bank
with ``split_bank`` (once for many calls: ``kernel_bank``) and each call's
columns in the launch. Bound and design: see the kernel source.
"""

from __future__ import annotations

import torch

from . import cuda_build

N_SYM = 8   # symmetric offsets per ring
N_CH = 8    # angle channels
TF = 128    # filters per CTA (the filter count must be a multiple)
TP = 16     # pairs per CTA, bf16 mode (pairs are zero-padded to a multiple)
TP_F32 = 8  # pairs per CTA, f32 mode
TK = 64     # pixels per stage (the pixel count must be a multiple)


def pair_columns(pt: torch.Tensor) -> torch.Tensor:
    """The bf16 mode's column operand of one side: (B, n_pixels, 8) ->
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


def split_bank(filters: torch.Tensor) -> torch.Tensor:
    """The f32 mode's bank on a CUDA device: (n_filters, n_pixels) ->
    planes (2, n_filters, n_pixels) float32, each element's tf32 hi part
    then its lo part (one launch). ``ring_distances_fused`` takes the
    planes in place of the bank, so a bank split once serves many calls."""
    x = filters.to(torch.float32).contiguous()
    if x.device.type != "cuda":
        raise ValueError("split_bank: the split planes are the CUDA "
                         "kernel's operand")
    if x.numel() % 4 or x.data_ptr() % 16:
        raise ValueError("split_bank: the bank must be 16-byte aligned and "
                         "hold a multiple of 4 values")
    planes = torch.empty((2, *x.shape), dtype=torch.float32,
                         device=x.device)
    lib = cuda_build.load("ring_dist")
    with torch.cuda.device(x.device):
        rc = lib.ring_split_bank_launch(
            x.data_ptr(), planes.data_ptr(), x.numel(),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, "split_bank")
    return planes


def kernel_bank(filters: torch.Tensor, *, bf16: bool) -> torch.Tensor:
    """The bank as ``ring_distances_fused`` takes it in the mode ``bf16``
    names, prepared once for many calls: cast to bf16 (bf16 mode), or
    split into tf32 planes on a CUDA device (f32 mode)."""
    return filters.to(torch.bfloat16) if bf16 else split_bank(filters)


def ring_distances_fused(filters: torch.Tensor, pt1: torch.Tensor,
                         pt2: torch.Tensor, *, bf16: bool = False
                         ) -> torch.Tensor:
    """Fused equivalent of ops.pair_distance.ring_distances.

    filters: (n_filters, n_pixels), ring-major, n_filters % 128 == 0 and
    n_pixels % 64 == 0; in the f32 mode on a CUDA device also its planes
    from ``split_bank`` (2, n_filters, n_pixels), and in the bf16 mode a
    bf16 bank skips the per-call cast (``kernel_bank`` prepares either).
    pt1/pt2: (B, n_pixels, 8). Returns (B, n_filters // 8) float32.
    ``bf16`` picks the mode: inputs rounded to bf16, or f32 products
    (3xTF32 on the card, the plain version's f32 matmul with TF32 off on
    the CPU).
    """
    split = filters.dim() == 3
    nf, npix = filters.shape[-2:]
    b = pt1.shape[0]
    if split and (bf16 or filters.shape[0] != 2
                  or filters.dtype != torch.float32
                  or filters.device.type != "cuda"):
        raise ValueError("split planes (2, n_filters, n_pixels) float32 "
                         "are the f32 mode's operand on a CUDA device")
    if nf % TF:
        raise ValueError(f"n_filters {nf} not a multiple of {TF}")
    if npix % TK:
        raise ValueError(f"n_pixels {npix} not a multiple of {TK}")
    if pt1.shape != (b, npix, N_CH) or pt2.shape != pt1.shape:
        raise ValueError(f"pt1/pt2 must be ({b}, {npix}, {N_CH}); got "
                         f"{tuple(pt1.shape)}, {tuple(pt2.shape)}")
    if filters.device.type == "cpu":
        return ring_distances_plain(filters, pt1, pt2, bf16=bf16)
    dev = filters.device
    if pt1.device != dev or pt2.device != dev:
        raise ValueError("filters, pt1 and pt2 must be on one device")
    out = torch.empty((b, nf // N_SYM), dtype=torch.float32, device=dev)
    lib = cuda_build.load("ring_dist")
    if bf16:
        f16 = filters.to(torch.bfloat16).contiguous()
        if f16.data_ptr() % 16:
            raise ValueError("ring_distances_fused: the bank must be "
                             "16-byte aligned (tensor-map tiles)")
        # one pair's 8 channels are one n8 slice of the wgmma accumulator
        p1, p2 = pair_columns(pt1), pair_columns(pt2)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.ring_dist_launch(f16.data_ptr(), p1.data_ptr(),
                                      p2.data_ptr(), out.data_ptr(), nf,
                                      npix, p1.shape[0], b, stream)
    else:
        planes = filters.contiguous() if split else split_bank(filters)
        p1 = pt1.to(torch.float32).contiguous()
        p2 = pt2.to(torch.float32).contiguous()
        if planes.data_ptr() % 16 or p1.data_ptr() % 16 \
                or p2.data_ptr() % 16:
            raise ValueError("ring_distances_fused: the bank's planes and "
                             "pt1/pt2 must be 16-byte aligned")
        # the split columns: 128 rows a pair tile (side 1's 8 pairs x 8
        # channels, then side 2's), as the tensor-map tiles load them
        cols = torch.empty((2, -(-b // TP_F32) * 2 * TP_F32 * N_CH, npix),
                           dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.ring_dist_f32_launch(planes.data_ptr(), p1.data_ptr(),
                                          p2.data_ptr(), cols.data_ptr(),
                                          out.data_ptr(), nf, npix, b,
                                          stream)
    cuda_build.check(rc, "ring_distances_fused")
    if bf16:
        ring_distances_fused.launches += 1
    else:
        ring_distances_fused.launches_f32 += 1
    return out


#: kernel launches since the count was last set to 0: the bf16 mode's,
#: and the f32 mode's apart
ring_distances_fused.launches = 0
ring_distances_fused.launches_f32 = 0
