"""Typed configuration for every pipeline stage.

A copy of ``opencv_dlco_tpu/utils/configs.py``: the same frozen
dataclasses, fields and defaults, so a config means the same run in both
packages. The ``precision`` properties return the precision's name
("highest" or "default") instead of a JAX enum.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class DescriptorConfig:
    """Patch -> oriented-gradient feature transform (reference: src/vgg-desc.cpp:41-152)."""

    patch_size: int = 64
    n_angle_bins: int = 8
    init_sigma: float = 1.4
    norm: bool = True
    norm_quantile: float = 0.8
    # precision of the stage-3 distance products: "highest" = true float32,
    # "default" = bf16 inputs with f32 accumulation through the fused ring
    # distance kernel (ops/pair_distance_fused.py)
    matmul_precision: str = "highest"

    @property
    def precision(self) -> str:
        return "highest" if self.matmul_precision == "highest" else "default"

    @property
    def n_pixels(self) -> int:
        return self.patch_size * self.patch_size


@dataclasses.dataclass(frozen=True)
class PoolRegionConfig:
    """Candidate pooling-region bank (reference: src/gen-poolregion.cpp:87-91,163-170)."""

    patch_size: int = 64
    nr: int = 32
    nphi: int = 5
    nsigma: int = 32
    n_symmetries: int = 8  # 8-fold symmetric offsets per ring

    @property
    def n_rings(self) -> int:
        return self.nr * self.nphi * self.nsigma

    @property
    def n_filters(self) -> int:
        return self.n_rings * self.n_symmetries


@dataclasses.dataclass(frozen=True)
class PRLearnConfig:
    """Pooling-region learner: L1-regularised hinge RDA (reference: src/pr-learn.cpp:76-84).

    ``batch`` minibatches the reference's per-sample loop: the RDA running
    average commutes over a batch, so ``n_iter`` counts *samples*
    (reference iterations), not optimizer steps.
    """

    mu: float = 0.025
    gamma: float = 0.10
    max_dim: int = 640
    n_iter: int = 5_000_000
    log_step: int = 100_000
    batch: int = 4096
    train_frac: float = 0.80
    seed: int = 2215
    n_angle_bins: int = 8
    # "block": random contiguous blocks of the pre-shuffled rows; "gather":
    # i.i.d. with replacement (reference semantics); "block_fused": block
    # mode through the fused RDA kernels (ops/fused_rda.py)
    sampling: str = "block"
    # "highest": true-f32 step products; "default": bf16 operands with f32
    # accumulation (scan path only; the fused kernels follow split_dtype)
    matmul_precision: str = "highest"
    # "f32" | "bf16": dtype of the device-resident training splits
    split_dtype: str = "f32"

    @property
    def precision(self) -> str:
        return "highest" if self.matmul_precision == "highest" else "default"


@dataclasses.dataclass(frozen=True)
class PJLearnConfig:
    """Projection learner: trace-norm hinge RDA + PSD projection (reference: src/pj-learn.cpp:88-96)."""

    mu: float = 0.001
    gamma: float = 0.500
    n_iter: int = 50_000
    log_step: int = 100
    batch: int = 200
    train_frac: float = 0.80
    seed: int = 2215
    # "exact"    -> full eigh every step (reference semantics);
    # "subspace" -> warm-started orthogonal iteration (approximate);
    # "psd_ns"   -> Newton-Schulz PSD projection in the hot loop (matmuls
    #               only) with one exact eigh per log period rebuilding W
    #               from df_avg (models/pj_rda.py).
    eigh_mode: str = "exact"
    subspace_steps: int = 4
    ns_iters: int = 24
    # With eigh_mode="subspace": track only the top-K eigenpairs (F x K
    # basis, W becomes K x F). None -> full basis.
    rank_cap: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class PRSweepGrid:
    """Reference PR grid: 16 mu x 16 gamma (workspace/04-prlearn.sh:8-14)."""

    mus: Tuple[float, ...] = (
        0.001, 0.002, 0.003, 0.004, 0.005, 0.010, 0.015, 0.020,
        0.025, 0.030, 0.035, 0.040, 0.045, 0.050, 0.055, 0.060,
    )
    gammas: Tuple[float, ...] = (
        0.005, 0.010, 0.015, 0.020, 0.025, 0.030, 0.040, 0.050,
        0.075, 0.100, 0.125, 0.150, 0.175, 0.200, 0.225, 0.250,
    )

    def combos(self) -> Sequence[Tuple[float, float]]:
        return [(m, g) for m in self.mus for g in self.gammas]


@dataclasses.dataclass(frozen=True)
class PJSweepGrid:
    """Reference PJ grid: 5 mu x 9 gamma (workspace/08-pjlearn.sh:10-14)."""

    mus: Tuple[float, ...] = (0.0001, 0.0005, 0.0010, 0.0020, 0.0030)
    gammas: Tuple[float, ...] = (
        0.025, 0.050, 0.100, 0.150, 0.200, 0.250, 0.500, 0.750, 1.000,
    )

    def combos(self) -> Sequence[Tuple[float, float]]:
        return [(m, g) for m in self.mus for g in self.gammas]
