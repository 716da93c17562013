"""The plain reference: float32 PyTorch with TF32 off, nothing of the
program imported."""

import torch


def set_tf32(on: bool) -> None:
    """TF32 in matmuls and convolutions: off for the reference, on for
    the control (the reference one precision lower)."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
