"""opencv_dlco_tpu_torch — the DLCO trainer in PyTorch, with CUDA kernels for Hopper.

A port of ``opencv_dlco_tpu`` (JAX/XLA/Pallas) that runs on one NVIDIA H100.
The JAX package is the reference; every public function here keeps its
counterpart's name, arguments and array layout, so the two can be held
against each other on the same numpy inputs.

Layout mirrors the JAX package:

- ``ops``      — patch transform, pooling-region bank, ring distances,
                 hinge, ROC stats, k-NN matching, corner detection, and the
                 wrappers of the hand-written CUDA kernels
                 (``pair_distance_fused``, ``fused_rda``, ``hinge``,
                 ``knn_fused``);
- ``geometry`` — SE(3)/Sim(3), triangulation, RANSAC essential, two-view
                 and multi-view BA, SE(3)/Sim(3) pose graphs;
- ``csrc``     — the CUDA C++ sources of those kernels (``sm_90a``), built
                 with ``nvcc`` at first use (``ops/cuda_build.py``);
- ``models``   — the PR and PJ RDA solvers, model selection and the
                 deployable VGG descriptor;
- ``parallel`` — the single-device PR and PJ sweep engines;
- ``data``     — HDF5 artifact store (same schema), Brown, HPatches and
                 KITTI ingestion, synthetic data;
- ``pipeline`` — stages 1-11 of the workflow over a Workspace directory,
                 the .i export, the descriptor evaluation protocols and
                 monocular SLAM;
- ``utils``    — configs, logs, progress, memory budget, checkpoints.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CPU tensor every kernel wrapper runs its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises.
"""

import torch


def no_tf32() -> None:
    """The f32 paths are held against JAX Precision.HIGHEST: no TF32 in
    matmuls or convolutions. Set at import and again by the entry points
    of the PJ learner and the VGG descriptor."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


no_tf32()

__version__ = "0.1.0"
