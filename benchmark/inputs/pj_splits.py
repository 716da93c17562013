"""The PJ grid's input: unprojected difference rows, split as stage 8 splits.

Stage 7 writes one row per pair, the difference of the two patches'
pooled descriptors over the best PR row's filters (F = 8 x filters),
values in [-1, 1]; stage 8 splits positives and negatives 80/20 into
train and validation. This maker draws such rows on the device from a
seed: Gaussian rows with a decaying spectrum mixed by a random rotation
(neighbouring pooling regions overlap, so the bins are correlated),
positives with a smaller spread than negatives, clamped to [-1, 1]. The
spreads and the spectrum are assumed (listed in the configuration's
``assumed``); the sizes are the m50 dataset's splits.
"""

from __future__ import annotations

import torch

from .patch_pairs import seed_of


def make(n_feat: int, n_trn: int, n_val: int, pos_std: float,
         neg_std: float, seed: int, device="cuda"):
    """{"pos_trn", "neg_trn", "pos_val", "neg_val"}: f32 (n, n_feat) on
    ``device``, the same arrays for the same seed."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed_of(seed, 2))
    k = torch.arange(n_feat, device=dev, dtype=torch.float32)
    spectrum = (k + 1.0) ** -0.5
    spectrum = spectrum / spectrum.square().mean().sqrt()
    mix, _ = torch.linalg.qr(torch.randn((n_feat, n_feat), generator=g,
                                         device=dev))
    basis = spectrum[:, None] * mix.T            # rows: scaled directions

    def rows(n, std):
        z = torch.randn((n, n_feat), generator=g, device=dev)
        return torch.clamp(std * (z @ basis), -1.0, 1.0)

    return {"pos_trn": rows(n_trn, pos_std), "neg_trn": rows(n_trn, neg_std),
            "pos_val": rows(n_val, pos_std), "neg_val": rows(n_val, neg_std)}
