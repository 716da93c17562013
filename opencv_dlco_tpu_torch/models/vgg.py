"""The deployed VGG descriptor model: patches -> compact descriptors.

Port of ``opencv_dlco_tpu/models/vgg.py``: what OpenCV contrib's VGG
descriptor computes from the exported artifacts (reference:
src/export-opencv.cpp emits PR/PJ for exactly this computation):

    PatchTrans = patch_transform(patch)               (n_pixels, n_bins)
    Desc       = min(PR @ PatchTrans, 1)  flattened   (n_sel * n_bins,)
    out        = PJ @ Desc                            (n_dim,)

L2 distances between projected descriptors equal the learned metric on
descriptor differences (||W(d1 - d2)|| = ||Wd1 - Wd2||), so this forward is
the deployed matcher front end. An ``nn.Module`` whose ``sel_filters`` and
``projection`` are buffers; the products are f32 with TF32 off (the JAX
package's HIGHEST).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import no_tf32
from ..ops.patch_transform import batch_patch_transform
from ..utils.configs import DescriptorConfig

DESCRIBE_BLOCK = 4096  # patches per forward in describe()


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"VGGDescriptor(device={device!r}): CUDA is not "
                           f"available; pass device='cpu'")
    return dev


class VGGDescriptor(nn.Module):
    """Frozen deployable descriptor: selected PR filters + projection."""

    def __init__(self, sel_filters, projection,
                 desc_cfg: DescriptorConfig = DescriptorConfig(),
                 device="cuda"):
        super().__init__()
        dev = _device(device)
        self.register_buffer("sel_filters", torch.as_tensor(
            np.asarray(sel_filters, np.float32)).to(dev))  # (n_sel, n_pixels)
        self.register_buffer("projection", torch.as_tensor(
            np.asarray(projection, np.float32)).to(dev))   # (n_dim, n_sel*nb)
        self.desc_cfg = desc_cfg

    @property
    def n_dim(self) -> int:
        return self.projection.shape[0]

    @classmethod
    def from_header(cls, header_text: str,
                    desc_cfg: DescriptorConfig = DescriptorConfig(),
                    device="cuda") -> "VGGDescriptor":
        """Load from an exported (or reference-published) vgg_generated .i."""
        from ..pipeline.export import parse_vgg_header

        mats = parse_vgg_header(header_text)
        return cls(mats["PR"], mats["PJ"], desc_cfg, device)

    @classmethod
    def from_artifacts(cls, filters_path: str, pr_ref: str, pj_path: str,
                       desc_cfg: DescriptorConfig = DescriptorConfig(),
                       device="cuda") -> "VGGDescriptor":
        """Load from workspace artifacts (filters.h5 + pr#row + pj)."""
        from ..data.store import ArtifactStore, parse_model_ref
        from .select import select_pr_filters

        with ArtifactStore(filters_path, "r") as st:
            filters = st.read("PRFilters")
        filters = filters.reshape(filters.shape[0], -1)
        pr_path, row = parse_model_ref(pr_ref)
        with ArtifactStore(pr_path, "r") as st:
            hist = st.read("w")
        w = hist[row]
        with ArtifactStore(pj_path, "r") as st:
            pj = st.read("W")
        pj = pj[np.any(pj != 0.0, axis=1)]
        return cls(select_pr_filters(filters, w), pj, desc_cfg, device)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        """(B, P, P) patches on the model's device -> (B, n_dim) f32."""
        no_tf32()
        pt = batch_patch_transform(patches, self.desc_cfg)  # (B, P^2, nb)
        pooled = torch.matmul(self.sel_filters, pt)           # (B, n_sel, nb)
        desc = torch.clamp(pooled, max=1.0).reshape(pt.shape[0], -1)
        return torch.matmul(desc, self.projection.T)

    @torch.no_grad()
    def describe(self, patches) -> torch.Tensor:
        """Descriptors of uint8 patches (numpy or tensor, any device), on
        the model's device, DESCRIBE_BLOCK patches per forward."""
        dev = self.projection.device
        x = torch.as_tensor(np.asarray(patches)) if not torch.is_tensor(
            patches) else patches
        outs = [self(x[s:s + DESCRIBE_BLOCK].to(dev))
                for s in range(0, x.shape[0], DESCRIBE_BLOCK)]
        if not outs:
            return torch.empty((0, self.n_dim), device=dev)
        return torch.cat(outs)
