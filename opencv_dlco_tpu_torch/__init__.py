"""opencv_dlco_tpu_torch — the DLCO trainer in PyTorch, with CUDA kernels for Hopper.

A port of ``opencv_dlco_tpu`` (JAX/XLA/Pallas) that runs on one NVIDIA H100.
The JAX package is the reference; every public function here keeps its
counterpart's name, arguments and array layout, so the two can be held
against each other on the same numpy inputs.

Layout mirrors the JAX package:

- ``ops``      — patch transform, pooling-region bank, ring distances,
                 sorted hinge, ROC stats, and the wrappers of the hand-written
                 CUDA kernels (``pair_distance_fused``, ``fused_rda``);
- ``csrc``     — the CUDA C++ sources of those kernels (``sm_90a``), built
                 with ``nvcc`` at first use (``ops/cuda_build.py``);
- ``models``   — the PR RDA solver and PR model selection;
- ``parallel`` — the single-device PR sweep engine;
- ``data``     — HDF5 artifact store (same schema), Brown ingestion,
                 synthetic data;
- ``pipeline`` — stages 1-6 of the workflow over a Workspace directory;
- ``utils``    — configs, logs, progress, memory budget, checkpoints.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CPU tensor every kernel wrapper runs its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises.
"""

import torch

# The f32 paths are held against JAX Precision.HIGHEST: no TF32 anywhere.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
